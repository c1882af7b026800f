from .glow import build_glow

__all__ = ["build_glow"]
