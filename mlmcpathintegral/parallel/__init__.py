from mlmcpathintegral.parallel.chains import (
    chain_mesh, shard_chains, distribute_n,
)
