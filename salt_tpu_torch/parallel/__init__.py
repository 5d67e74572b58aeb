"""Scale-out of the aligner: the index sharded by reference bin
(sharded.py, sharded_engine.py), reads split over a list of devices
(mesh.py), and processes that share a directory of part files
(driver.py).  Port of salt_tpu/parallel/.

A "mesh" here is a Python list of torch devices, which may hold the same
device more than once: one process drives them all, and nothing is
exchanged between processes but files.
"""
