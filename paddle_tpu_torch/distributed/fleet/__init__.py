"""Fleet helpers of the port (``fleet.base.zero_shard_spec``)."""
