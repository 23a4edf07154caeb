"""The multi-device full-batch path: the shards and their collectives
(``mesh``), the halo-partitioned SpMM and affinity (``spmm_shard``) and
the halo GGAD step (``halo_trainer``)."""
