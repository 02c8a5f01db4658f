"""Launch helpers: meshes and the local rank spawner."""
from repro_torch.launch.mesh import (make_cpu_mesh, make_production_mesh,
                                     make_test_mesh, mesh_axes, parse_mesh,
                                     run_ranks)

__all__ = ["make_cpu_mesh", "make_production_mesh", "make_test_mesh",
           "mesh_axes", "parse_mesh", "run_ranks"]
