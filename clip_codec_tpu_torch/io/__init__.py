from .bitstream import MAGIC, VERSION, compress_frame, decompress_frame, read_bitstream, write_bitstream

__all__ = ["MAGIC", "VERSION", "compress_frame", "decompress_frame", "read_bitstream", "write_bitstream"]
