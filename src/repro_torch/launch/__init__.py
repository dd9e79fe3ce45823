"""Launch layer: the serving CLI (:mod:`.serve`) and the training CLI
(:mod:`.train`).

The reference's meshes, sharding rules and dry-run are not ported yet
(ROADMAP queue 1).
"""
