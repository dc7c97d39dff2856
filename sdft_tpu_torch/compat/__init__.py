from .sdft import SDFT
from .stft import STFT

__all__ = ["SDFT", "STFT"]
