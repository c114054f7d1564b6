"""Track sharding over a mesh of devices (mesh.py) and its dry run (dryrun.py)."""
