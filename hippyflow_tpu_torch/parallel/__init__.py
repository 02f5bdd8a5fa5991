"""The parallel layer (port of ``hippyflow_tpu/parallel``): collectives
over a ``torch.distributed`` device mesh and the dof-sharded banded
operators."""

from .collective import (
    CollectiveOperator,
    DeviceCollective,
    MatrixMultCollectiveOperator,
    NullCollective,
    check_consistent_sharding,
    initialize_distributed,
    make_multislice_mesh,
    make_sample_fem_mesh,
)
from .dist_banded import (
    DistributedBandedFactor,
    dist_block_tridiag_matmat,
    factorize_distributed_banded,
    place_on_mesh,
)
