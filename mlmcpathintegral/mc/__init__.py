from mlmcpathintegral.mc.singlelevel import MonteCarloSingleLevel
from mlmcpathintegral.mc.twolevelstep import (
    TwoLevelMetropolisStep, TwoLevelState,
)
from mlmcpathintegral.mc.twolevel import MonteCarloTwoLevel
from mlmcpathintegral.mc.multilevel import MonteCarloMultiLevel
