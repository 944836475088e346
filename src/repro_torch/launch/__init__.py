# Launch layer on one device: the training driver (train.py).  The
# reference's production meshes, dry-run cell builders and roofline
# analysis come with the distributed slice.
