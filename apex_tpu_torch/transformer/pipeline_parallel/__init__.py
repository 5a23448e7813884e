"""Pipeline parallelism over ``torch.distributed`` (port of the JAX
package's ``apex_tpu/transformer/pipeline_parallel``): the schedules
(:mod:`.schedules`), the stage-to-stage transfers
(:mod:`.p2p_communication`), ``build_model``, the utilities, the
microbatch calculators and the named timers."""

from apex_tpu_torch.transformer.pipeline_parallel._timers import (  # noqa: F401
    Timers,
)
from apex_tpu_torch.transformer.pipeline_parallel.build_model import (  # noqa: F401
    build_model,
)
from apex_tpu_torch.transformer.pipeline_parallel.microbatches import (  # noqa: F401
    ConstantNumMicroBatches,
    NumMicroBatchesCalculator,
    RampupBatchsizeNumMicroBatches,
    build_num_microbatches_calculator,
)
from apex_tpu_torch.transformer.pipeline_parallel.p2p_communication import (  # noqa: F401
    recv_backward,
    recv_forward,
    send_backward,
    send_backward_recv_backward,
    send_backward_recv_forward,
    send_forward,
    send_forward_recv_backward,
    send_forward_recv_forward,
)
from apex_tpu_torch.transformer.pipeline_parallel.schedules import (  # noqa: F401
    forward_backward_no_pipelining,
    forward_backward_pipelining_with_interleaving,
    forward_backward_pipelining_without_interleaving,
    get_forward_backward_func,
)
from apex_tpu_torch.transformer.pipeline_parallel.utils import (  # noqa: F401
    average_losses_across_data_parallel_group,
    calc_params_l2_norm,
    check_adlr_autoresume_termination,
    destroy_microbatch_calculator,
    get_autoresume,
    get_current_global_batch_size,
    get_kth_microbatch,
    get_ltor_masks_and_position_ids,
    get_micro_batch_size,
    get_num_microbatches,
    listify_model,
    print_params_min_max_norm,
    report_memory,
    setup_microbatch_calculator,
    split_into_microbatches,
    unwrap_model,
    update_num_microbatches,
)

__all__ = ["ConstantNumMicroBatches", "NumMicroBatchesCalculator",
           "RampupBatchsizeNumMicroBatches", "Timers",
           "build_num_microbatches_calculator", "build_model",
           "forward_backward_no_pipelining",
           "forward_backward_pipelining_with_interleaving",
           "forward_backward_pipelining_without_interleaving",
           "get_forward_backward_func", "recv_forward", "send_forward",
           "recv_backward", "send_backward", "send_forward_recv_backward",
           "send_backward_recv_forward", "send_forward_recv_forward",
           "send_backward_recv_backward",
           "average_losses_across_data_parallel_group",
           "calc_params_l2_norm", "check_adlr_autoresume_termination",
           "destroy_microbatch_calculator", "get_autoresume",
           "get_current_global_batch_size", "get_kth_microbatch",
           "get_ltor_masks_and_position_ids", "get_micro_batch_size",
           "get_num_microbatches", "listify_model",
           "print_params_min_max_norm", "report_memory",
           "setup_microbatch_calculator", "split_into_microbatches",
           "unwrap_model", "update_num_microbatches"]
