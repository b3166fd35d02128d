"""FedPara core (PyTorch): parameterizations, the rank policy, the
Prop.-3 conv parameterization and the Jacobian correction."""
from repro_torch.core import (parameterization, rank_policy, regularization,
                              tensor_fedpara)

__all__ = ["parameterization", "rank_policy", "regularization",
           "tensor_fedpara"]
