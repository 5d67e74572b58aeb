"""Whole-genome drivers of salt_tpu_torch: bench_large (build, load and
align a genome of up to 3.1 G bases, monolithic or sharded by reference
bin) and build_sharded (the sharded build, one shard a process)."""
