from .mlp import MLP, ThetaPosteriorNet, ZPredictiveNet, init_vi_networks, load_flax_params

__all__ = ["MLP", "ThetaPosteriorNet", "ZPredictiveNet", "init_vi_networks", "load_flax_params"]
