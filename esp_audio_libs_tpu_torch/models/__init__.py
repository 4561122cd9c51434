from .resampler import Resampler, ResamplerConfiguration, ResamplerResults  # noqa: F401

__all__ = ["Resampler", "ResamplerConfiguration", "ResamplerResults"]
