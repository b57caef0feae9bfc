from .convert import from_flax, load_flax

__all__ = ["from_flax", "load_flax"]
