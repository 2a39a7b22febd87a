"""The port's native host libraries (counterpart of adaptive_tpu/native):
the RLE mask API (``mask``) and the columnar JSON scanner that
data/fast_json.py loads. Importing builds nothing: each library builds and
loads inside its first call (build.py)."""
from adaptive_tpu_torch.native import mask  # noqa: F401
