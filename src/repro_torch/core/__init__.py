"""FedPara core (PyTorch): parameterizations and the rank policy."""
from repro_torch.core import parameterization, rank_policy

__all__ = ["parameterization", "rank_policy"]
