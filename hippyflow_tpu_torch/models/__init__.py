from .active_subspace import ActiveSubspaceParameterList, ActiveSubspaceProjector
from .data_generator import (
    DataGenerator,
    chunk_keychain,
    contiguous_prefix_end,
    data_generator_settings,
    load_chunks_validated,
    prune_stale_chunks,
)
from .jacobian import (
    ObservableControlJacobian,
    ObservableJacobian,
    jjt_matmat,
    jtj_matmat,
)
from .kle import (
    KLEParameterList,
    KLEProjector,
    KLESubspaceConstructor,
    MassPreconditionedCovarianceOperator,
)
from .observable import LinearStateObservable, PointwiseObservation
from .pod import (
    PODParameterList,
    PODProjector,
    PODProjectorFromData,
    weighted_l2_norm_vector,
)
from .pde_problem import (
    ADJOINT,
    CONTROL,
    PARAMETER,
    STATE,
    IterativeFactor,
    Linearization,
    NewtonInfo,
    VariationalPDEProblem,
    bicgstab,
)
from .prior import BiLaplacian2D, BiLaplacianPrior, StructuredBiLaplacianPrior
from .sampling import (
    SampleBatch,
    auto_chunk_size,
    UniformDistribution,
    fresh_solves,
    linearize_batch,
    materialize_jacobians,
    sample_and_materialize_symmetric,
    sample_until_solved,
)
