"""Launchers of the LM stack (port of `repro.launch`): `serve`, `train`
and the mesh constructors `mesh`. The reference's `dryrun` and `specs`
wait for the dry-run slice (ROADMAP Queue 1 item 9)."""
