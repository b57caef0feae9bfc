from .attention import AttentionLayer, causal_mask, full_attention, prob_sparse_attention
from .embed import DataEmbedding, TokenEmbedding, circular_conv1d, sinusoid_position_encoding
from .informer import Informer, InformerBase, InformerStack, build_informer
from .informer_lsq import build_informer_lsq

__all__ = [
    "AttentionLayer",
    "causal_mask",
    "full_attention",
    "prob_sparse_attention",
    "DataEmbedding",
    "TokenEmbedding",
    "circular_conv1d",
    "sinusoid_position_encoding",
    "Informer",
    "InformerBase",
    "InformerStack",
    "build_informer",
    "build_informer_lsq",
]
