"""Launch layer: the serving CLI (:mod:`.serve`).

The reference's meshes, sharding rules, dry-run and train CLI are not
ported yet (ROADMAP queue 1).
"""
