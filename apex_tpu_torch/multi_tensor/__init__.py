"""Multi-tensor ops (l2 norm, scale, axpby, global-norm clipping), the
superblock (one flat buffer for a whole tree) and its bucket planner."""

from apex_tpu_torch.multi_tensor.buckets import (  # noqa: F401
    DEFAULT_BUCKET_BYTES,
    BucketPlan,
    plan_buckets,
)
from apex_tpu_torch.multi_tensor.flat import (  # noqa: F401
    FlatSchema,
    PartitionSpec,
    flatten,
    is_replicated_stack,
    make_schema,
    reshard_stack_device,
    reshard_tree,
    spec_lead_axes,
    unflatten,
)
from apex_tpu_torch.multi_tensor.ops import (  # noqa: F401
    clip_grad_norm,
    multi_tensor_axpby,
    multi_tensor_l2norm,
    multi_tensor_scale,
    segment_l2norms,
)

__all__ = ["DEFAULT_BUCKET_BYTES", "BucketPlan", "plan_buckets",
           "FlatSchema", "PartitionSpec", "flatten", "is_replicated_stack",
           "make_schema", "reshard_stack_device", "reshard_tree",
           "spec_lead_axes", "unflatten",
           "clip_grad_norm", "multi_tensor_axpby", "multi_tensor_l2norm",
           "multi_tensor_scale", "segment_l2norms"]
