"""Launch helpers: meshes and the local rank spawner (``mesh``), the
step functions and specs of every (arch x shape) cell (``steps``), and the
``train`` and ``serve`` launchers (``python -m repro_torch.launch.train``
/ ``.serve``)."""
from repro_torch.launch.mesh import (choose_config, launcher_mesh,
                                     make_cpu_mesh, make_production_mesh,
                                     make_test_mesh, mesh_axes, parse_mesh,
                                     run_printing_rank0, run_ranks)

__all__ = ["choose_config", "launcher_mesh", "make_cpu_mesh",
           "make_production_mesh", "make_test_mesh", "mesh_axes",
           "parse_mesh", "run_printing_rank0", "run_ranks"]
