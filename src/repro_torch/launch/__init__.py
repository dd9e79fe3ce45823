"""Launch layer: the serving CLI (:mod:`.serve`), the training CLI
(:mod:`.train`), meshes (:mod:`.mesh`) and the runtime state's sharding
rules (:mod:`.sharding`).

The reference's dry run, HLO cost reader and roofline are not ported
yet (ROADMAP queue 1).
"""
