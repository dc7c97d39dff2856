from .streamer import Streamer, iter_blocks

__all__ = ["Streamer", "iter_blocks"]
