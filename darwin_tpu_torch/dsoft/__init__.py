"""D-SOFT seed filtration: on the host (filter.py; the native library's
multithreaded D-SOFT is darwin_tpu_torch.native.dsoft_batch) and on the
device (device.py, the csrc/dsoft.cu kernel)."""

from darwin_tpu_torch.dsoft.filter import dsoft

__all__ = ["dsoft"]
