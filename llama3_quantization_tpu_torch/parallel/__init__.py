"""Parallelism over `torch.distributed` (port of
`llama3_quantization_tpu/parallel/`).

JAX distributes with GSPMD: one mesh with `dp` / `tp` axes, parameter
PartitionSpecs, and jitted programs into which XLA inserts the collectives.
The port runs one process per device (`distributed.init_distributed`: NCCL
on the card, gloo on the CPU) over a `DeviceMesh` with JAX's axis names
(`mesh.make_mesh`), and Megatron-style parallelism by hand: rank-local
trees (`sharding.shard_params`) whose entry points all-reduce and gather
where GSPMD would, the ring collective matmuls and the tp-overlap forward,
the GPipe pipeline, ring attention over `sp`, sharded GPTQ and the sharded
LWC training step. No module here has a kernel of its own: the matmuls and
attention reach B1/B2/B3, B5/B6 and B7 through the model's wrappers.
"""

from .calibrate import (  # noqa: F401
    sharded_gptq_quantize_weight,
    sharded_hessian_update,
)
from .collective_matmul import ag_matmul, rs_matmul  # noqa: F401
from .mesh import make_mesh  # noqa: F401
from .pipeline import (  # noqa: F401
    make_pipeline_forward,
    pipeline_pspecs,
    shard_params_pipeline,
)
from .ring_attention import make_sp_forward, ring_attention  # noqa: F401
from .tp_overlap import make_tp_overlap_forward, tp_overlap_pspecs  # noqa: F401
from .sharding import (  # noqa: F401
    make_sharded_forward,
    model_pspecs,
    seq2seq_pspecs,
    shard_kv_cache,
    shard_params,
    shard_params_seq2seq,
)
