"""The multi-device paths: the sharding rules (`sharding`) and the
collectives of the JAX package's shard_map bodies (`collectives`)."""
