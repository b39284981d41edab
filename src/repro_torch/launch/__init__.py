"""Launchers of the LM stack (port of `repro.launch`): `serve`. The
reference's `dryrun`, `mesh`, `specs` and `train` wait for the sharded
executor and training (ROADMAP Queue 1 items 7 and 8)."""
