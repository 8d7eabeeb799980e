from repro_torch.configs.base import ARCH_IDS, all_configs, get_config, resolve

__all__ = ["ARCH_IDS", "all_configs", "get_config", "resolve"]
