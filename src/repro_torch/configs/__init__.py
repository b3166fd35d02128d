"""Config registry: importing this package registers the ported archs."""
from repro_torch.configs import base
from repro_torch.configs.base import ArchConfig, ParamCfg, get_arch, register

# Ported architectures (importing registers them).
from repro_torch.configs import qwen3_8b  # noqa: E402,F401

__all__ = ["base", "ArchConfig", "ParamCfg", "get_arch", "register"]
