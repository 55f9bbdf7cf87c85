"""The port's model code: the ``Model`` builder of the ten architectures
(``model``) over the layer library (``layers``: norms, RoPE, attention
with its KV cache, MLPs), the Mamba layers (``ssm``), the MoE layer
whose dispatch is the OpSparse binning (``moe``), int8 weights
(``quant``), the parameter specs and tree helpers (``param``) and the
reference's sharding hints, which are the identity on one card
(``hints``)."""
from . import hints, layers, model, moe, param, quant, ssm
from .model import Model
from .moe import MoE, moe_dense_dispatch, moe_specs

__all__ = ["hints", "layers", "model", "moe", "param", "quant", "ssm",
           "Model", "MoE", "moe_dense_dispatch", "moe_specs"]
