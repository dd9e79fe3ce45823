"""Launch layer: the serving CLI (:mod:`.serve`, ``ServeEngine`` also on a
mesh), the training CLI (:mod:`.train`), meshes (:mod:`.mesh`), the
runtime state's sharding rules (:mod:`.sharding`), and the dry run
(:mod:`.dryrun`) with its per-rank op counter (:mod:`.op_cost`, the
stand-in for the reference's ``hlo_cost``) and the H100 roofline
(:mod:`.roofline`).
"""
from .mesh import make_production_mesh, make_host_mesh, data_axes
from . import dryrun, mesh, op_cost, roofline, serve, sharding, train

__all__ = ["make_production_mesh", "make_host_mesh", "data_axes",
           "dryrun", "mesh", "op_cost", "roofline", "serve", "sharding",
           "train"]
