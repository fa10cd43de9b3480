"""Matrix constructors for tests, examples and benchmarks."""

from .rand import rand_csr
from .special import dirichlet_laplacian, grid_laplacian, tri_mesh_graph_laplacian
