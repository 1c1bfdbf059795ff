from repro_torch.kernels.delta_codec.ops import (COMPRESS_RATIO, codec_ratio,
                                                 decode_delta, encode_delta,
                                                 payload_bytes,
                                                 stacked_flatten,
                                                 stacked_unflatten)
from repro_torch.kernels.delta_codec.ref import dequantize_ref, quantize_ref

__all__ = ["COMPRESS_RATIO", "codec_ratio", "decode_delta", "dequantize_ref",
           "encode_delta", "payload_bytes", "quantize_ref", "stacked_flatten",
           "stacked_unflatten"]
