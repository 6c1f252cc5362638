from mlmcpathintegral.distributions.rejection import batched_rejection_sample
from mlmcpathintegral.distributions.expsin2 import ExpSin2Distribution
from mlmcpathintegral.distributions.expcos import ExpCosDistribution
from mlmcpathintegral.distributions.compactexp import CompactExpDistribution
from mlmcpathintegral.distributions.besselproduct import (
    BesselProductDistribution,
)
from mlmcpathintegral.distributions.approxbesselproduct import (
    ApproximateBesselProductDistribution,
)
from mlmcpathintegral.distributions.gaussianfillin import (
    GaussianFillinDistribution,
)
