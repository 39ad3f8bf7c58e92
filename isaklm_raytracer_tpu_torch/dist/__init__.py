from isaklm_raytracer_tpu_torch.dist.sharding import (
    gbuffer_progress,
    make_render_mesh,
    render_sharded,
    shard_gbuffer,
    sharded_render_fn,
    sharded_train_step_fn,
    sharded_value_and_grad_fn,
    unshard_gbuffer,
)

__all__ = [
    "gbuffer_progress",
    "make_render_mesh",
    "render_sharded",
    "shard_gbuffer",
    "sharded_render_fn",
    "sharded_train_step_fn",
    "sharded_value_and_grad_fn",
    "unshard_gbuffer",
]
