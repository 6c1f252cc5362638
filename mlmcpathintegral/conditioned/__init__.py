from mlmcpathintegral.conditioned.base import ConditionedFineAction
from mlmcpathintegral.conditioned.qm import (
    GaussianConditionedFineAction, RotorConditionedFineAction,
    make_conditioned_fine_action,
)
from mlmcpathintegral.conditioned.gff import GFFConditionedFineAction
from mlmcpathintegral.conditioned.schwinger import (
    QuenchedSchwingerConditionedFineAction,
    QuenchedSchwingerGaussianConditionedFineAction,
    QuenchedSchwingerSemiConditionedFineAction,
    make_schwinger_conditioned_fine_action,
)
from mlmcpathintegral.conditioned.sigma import (
    NonlinearSigmaConditionedFineAction,
)
