from .fastjpeg import decode_jpeg_batch, is_available, probe_jpeg  # noqa: F401
