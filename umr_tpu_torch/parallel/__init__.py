from .mesh import (  # noqa: F401
    all_reduce_,
    barrier,
    is_writer,
    launch,
    make_mesh,
    rank_and_size,
    rank_block,
    rank_generator,
    replicate,
    shard_batch,
    spawn,
    world_size,
)
