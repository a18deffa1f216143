from pynama_tpu_torch.parallel.sharded_engine import ShardedEngine, \
    build_sharded_ops
