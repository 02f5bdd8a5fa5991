from .active_subspace import ActiveSubspaceParameterList, ActiveSubspaceProjector
from .jacobian import ObservableJacobian
from .observable import LinearStateObservable, PointwiseObservation
from .pde_problem import Linearization, NewtonInfo, VariationalPDEProblem
from .prior import BiLaplacian2D, BiLaplacianPrior, StructuredBiLaplacianPrior
from .sampling import (
    SampleBatch,
    auto_chunk_size,
    materialize_jacobians,
    sample_until_solved,
)
