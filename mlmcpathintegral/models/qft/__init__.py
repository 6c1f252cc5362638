from mlmcpathintegral.models.qft.gff import GFFAction
