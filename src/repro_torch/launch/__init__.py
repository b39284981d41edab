"""Launchers of the LM stack (port of `repro.launch`): `serve` and
`train`. The reference's `dryrun`, `mesh` and `specs` wait for the
sharded executor (ROADMAP Queue 1 item 7)."""
