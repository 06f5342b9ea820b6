"""Constants of the port's parallel training path: its own copies of the
JAX package's tables (`accelerate_tpu/utils/constants.py`), which it may not
import.

The mesh axes keep JAX's names and order (outer to inner). The port builds
its `DeviceMesh` over ("data", "fsdp") and, for tensor parallel, "model":
the batch is split over the first two, parameters and optimizer state
shard over "fsdp" and replicate over "data", and the family's Megatron
table splits them over "model". The other axes (seq, expert, stage,
pipeline) belong to parts of the JAX package the port has not taken yet
(ROADMAP A item 3).
"""

MESH_AXIS_NAMES = ("data", "fsdp", "model", "seq", "expert", "stage", "pipeline")
DATA_AXES = ("data", "fsdp")

FSDP_SHARDING_STRATEGY = ["FULL_SHARD", "SHARD_GRAD_OP", "NO_SHARD", "HYBRID_SHARD", "HYBRID_SHARD_ZERO2"]
FSDP_STATE_DICT_TYPE = ["FULL_STATE_DICT", "SHARDED_STATE_DICT"]
FSDP_AUTO_WRAP_POLICY = ["TRANSFORMER_BASED_WRAP", "SIZE_BASED_WRAP", "NO_WRAP"]
