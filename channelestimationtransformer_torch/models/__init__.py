from .attention import AttentionLayer, causal_mask, full_attention, prob_sparse_attention
from .embed import DataEmbedding, TokenEmbedding, circular_conv1d, sinusoid_position_encoding
from .informer import Informer, InformerBase, InformerStack, build_informer
from .informer_lsq import build_informer_lsq
from .recurrent import RecurrentPredictor, build_recurrent
from .streaming import StreamState, init_stream, push_block, streaming_rollout, streaming_step
from .transformer import PreNormBlock, Transformer, build_transformer

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
    "RecurrentPredictor",
    "build_recurrent",
    "StreamState",
    "init_stream",
    "push_block",
    "streaming_rollout",
    "streaming_step",
    "PreNormBlock",
    "Transformer",
    "build_transformer",
]
