from .flow import ThetaPosteriorFlowNet, flow_moments
from .mlp import (
    MLP,
    ThetaPosteriorFullCovNet,
    ThetaPosteriorNet,
    ZPredictiveNet,
    init_vi_networks,
    load_flax_params,
    marginal_variance,
)

__all__ = ["MLP", "ThetaPosteriorNet", "ThetaPosteriorFullCovNet", "ThetaPosteriorFlowNet",
           "ZPredictiveNet", "flow_moments", "init_vi_networks", "load_flax_params",
           "marginal_variance"]
