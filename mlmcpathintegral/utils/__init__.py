from mlmcpathintegral.utils.special import (
    mod_2pi,
    mod_pi,
    fast_i0_scaled,
    log_2pi_i0_scaled,
    log_i0,
    Sigma_hat,
    Phi_chit,
    Phi_chit_perturbative,
    compute_In,
    gff_phi_squared_analytical,
    log_factorial,
    log_nCk,
)
from mlmcpathintegral.utils.statistics import Statistics
from mlmcpathintegral.utils.timer import Timer
from mlmcpathintegral.utils.config import Section, read_parameter_file
from mlmcpathintegral.utils.checkpoint import (
    checkpoint_metadata, load_checkpoint, save_checkpoint,
)
