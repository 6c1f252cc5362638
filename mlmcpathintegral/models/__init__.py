from mlmcpathintegral.models.base import Action, QMAction, RenormalisationType
from mlmcpathintegral.models.harmonic import HarmonicOscillatorAction
from mlmcpathintegral.models.quartic import QuarticOscillatorAction
from mlmcpathintegral.models.rotor import RotorAction
