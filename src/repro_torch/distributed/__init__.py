"""The multi-device layer of the port: the pod axis (``pods``) and the int8
error-feedback gradient leg over it (``compression``)."""
from .compression import (compress_allreduce_pods, compression_wire_bytes,
                          dequantize_int8, ef_init, quantize_int8)
from .pods import DistPods, LoopPods, Pods

__all__ = ["DistPods", "LoopPods", "Pods", "compress_allreduce_pods",
           "compression_wire_bytes", "dequantize_int8", "ef_init",
           "quantize_int8"]
