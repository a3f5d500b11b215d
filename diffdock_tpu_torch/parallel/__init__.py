from diffdock_tpu_torch.parallel.mesh import (
    make_mesh,
    shard_train_step,
    shard_pose_sampler,
)

__all__ = ["make_mesh", "shard_train_step", "shard_pose_sampler"]
