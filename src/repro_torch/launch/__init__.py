# Launch layer: production meshes, dry-run cells, roofline analysis,
# the training loop.  NOTE: dryrun.py starts a fake process
# group at import: import it only as a script entry point.
