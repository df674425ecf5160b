"""Utility layer of the port: alphabets, ranges, hashing, metrics, host
pipelining (the reference's utils.{h,cpp}, L1 in SURVEY.md §1).  Port of
bwtmerge_tpu/utils, without its JAX set-up."""
