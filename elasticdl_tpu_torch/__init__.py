"""ElasticDL on PyTorch for one NVIDIA H100.

The PyTorch counterpart of `elasticdl_tpu`: the same elastic
master/PS protocol (GetTask, ReportGradient with the model piggybacked
back, window mode's ReportLocalUpdate deltas, the exactness block
`version == init + applied update steps`, the sparse plane's
PS-resident embedding tables and KV shards),
with attention on CUDA kernels written by hand for Hopper
(`ops/csrc/flash_attention.cu`). The JAX package is the reference; this
package imports nothing of it and keeps its own copies of what it needs.

Entry points run on the card unless the caller asks for the CPU
(`device="cpu"`), which the tests do.
"""

__version__ = "0.1.0"
