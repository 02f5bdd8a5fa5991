from .active_subspace import ActiveSubspaceParameterList, ActiveSubspaceProjector
from .cminimization import ConstrainedNSolver, newtonSolver_ParameterList
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
    BoundaryRestrictedKLEProjector,
    KLEParameterList,
    KLEProjector,
    KLESubspaceConstructor,
    MassPreconditionedCovarianceOperator,
)
from .model_wrapper import ModelWrapper, PointwiseMisfit, modelWrapperSettings
from .multi_pde import BlockVector, MultiPDEProblem, MultiStateLinearObservable
from .observable import (
    DomainRestrictedOperator,
    LinearStateObservable,
    PointwiseObservation,
    StateSpaceIdentityOperator,
)
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
from .prior import (
    BiLaplacian2D,
    BiLaplacianPrior,
    Laplacian2D,
    LaplacianPrior,
    StructuredBiLaplacianPrior,
    aniso_tensor_2d,
)
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
