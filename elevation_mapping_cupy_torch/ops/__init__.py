"""Map operations: geometry, scatters, fusion, ray cleanup, stencils."""
