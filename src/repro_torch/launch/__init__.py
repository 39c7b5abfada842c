"""Dry-run launcher on H100-node meshes (port of `repro/launch/`):
`mesh.py` builds the production meshes, `cells.py` the (arch x shape)
cells, `roofline.py` prices them with the H100's datasheet figures, and
`dryrun.py` traces each on a fake world of ranks."""
