from repro_torch.checkpoint.partition import (  # noqa: F401
    ensure_quantized, from_jax_params, load_manifest, load_shard,
    partition_and_save, requantize, shard_names, to_numpy)
from repro_torch.checkpoint.quant import QuantizedTensor  # noqa: F401
