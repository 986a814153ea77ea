from repro_torch.checkpoint.partition import (  # noqa: F401
    from_jax_params, load_manifest, load_shard, partition_and_save,
    shard_names, to_numpy)
