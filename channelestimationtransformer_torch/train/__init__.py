from .trainer import eval_chunk, eval_step

__all__ = ["eval_chunk", "eval_step"]
