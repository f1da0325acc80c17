"""scripts — operational command-line tools (the port of
``veles_tpu/scripts``; rebuild of veles/scripts/): ``bboxer`` (the
bounding-box labeling web tool), ``compare_snapshots`` (parameter
diffing of the port's snapshots and the JAX package's) and
``update_forge`` (publishing packaged workflows to a forge server)."""
