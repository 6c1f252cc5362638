from mlmcpathintegral.samplers.base import Sampler
from mlmcpathintegral.samplers.hmc import HMCSampler, HMCState
from mlmcpathintegral.samplers.heatbath import OverrelaxedHeatBathSampler
from mlmcpathintegral.samplers.cluster import ClusterSampler
from mlmcpathintegral.samplers.cluster2d import Cluster2DSampler
from mlmcpathintegral.samplers.exact import ExactSampler
from mlmcpathintegral.samplers.hierarchical import HierarchicalSampler
from mlmcpathintegral.samplers.multilevel import MultilevelSampler
from mlmcpathintegral.samplers.schwingercluster import (
    QuenchedSchwingerClusterSampler,
)
