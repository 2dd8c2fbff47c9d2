from hpvpinns_tpu_torch.parallel.sharding import (
    element_mesh,
    pad_elements,
    replicate,
    shard_problem,
)
