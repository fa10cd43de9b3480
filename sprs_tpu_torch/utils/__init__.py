"""Matrix constructors for tests, examples and benchmarks."""

from .special import dirichlet_laplacian, grid_laplacian
