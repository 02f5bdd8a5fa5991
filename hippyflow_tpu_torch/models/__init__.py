from .active_subspace import ActiveSubspaceParameterList, ActiveSubspaceProjector
from .jacobian import ObservableJacobian
from .observable import LinearStateObservable, PointwiseObservation
from .pod import PODProjectorFromData, weighted_l2_norm_vector
from .pde_problem import Linearization, NewtonInfo, VariationalPDEProblem
from .prior import BiLaplacian2D, BiLaplacianPrior, StructuredBiLaplacianPrior
from .sampling import (
    SampleBatch,
    auto_chunk_size,
    materialize_jacobians,
    sample_and_materialize_symmetric,
    sample_until_solved,
)
