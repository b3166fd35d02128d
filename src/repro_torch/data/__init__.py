"""Synthetic datasets, client partitions and local-epoch batches: numpy
copies of the reference's ``repro.data`` pieces that the FL training
path needs (the port never imports the reference)."""
from repro_torch.data.loader import client_epochs, client_step_count
from repro_torch.data.partition import dirichlet_partition, iid_partition
from repro_torch.data.synthetic import (make_image_dataset,
                                       make_token_lm_dataset,
                                       train_test_split)

__all__ = ["client_epochs", "client_step_count", "dirichlet_partition",
           "iid_partition", "make_image_dataset", "make_token_lm_dataset",
           "train_test_split"]
