"""Multi-card scale-out of the port: the pages x glyphs mesh (mesh.py) and the
mesh-sharded focr grid step (decode.py). Counterpart of focr_tpu/parallel/."""
