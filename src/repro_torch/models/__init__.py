"""The port's model code: the MoE layer whose dispatch is the OpSparse
binning (``moe``), with its parameter specs (``param``) and the
reference's sharding hints, which are the identity on one card
(``hints``)."""
from . import hints, moe, param
from .moe import MoE, moe_dense_dispatch, moe_specs

__all__ = ["hints", "moe", "param", "MoE", "moe_dense_dispatch",
           "moe_specs"]
