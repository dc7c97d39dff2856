from .dump import dump_complex, load_complex
from .wav import read_wav, write_wav

__all__ = ["read_wav", "write_wav", "dump_complex", "load_complex"]
