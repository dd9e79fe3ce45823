"""Launch layer: the serving CLI (:mod:`.serve`, ``ServeEngine`` also on a
mesh), the training CLI (:mod:`.train`), meshes (:mod:`.mesh`), the
runtime state's sharding rules (:mod:`.sharding`), and the dry run
(:mod:`.dryrun`) with its per-rank op counter (:mod:`.op_cost`, the
stand-in for the reference's ``hlo_cost``) and the H100 roofline
(:mod:`.roofline`).
"""
from . import dryrun, mesh, op_cost, roofline, serve, sharding, train

__all__ = ["dryrun", "mesh", "op_cost", "roofline", "serve", "sharding",
           "train"]
