"""Config parser + driver smoke tests (reference: src/common/parameters.cc
and the driver executables)."""

import pytest

from mlmcpathintegral.utils.config import Section, read_parameter_file

TEMPLATE = """
# comment
general:
  method = 'twolevel'   # trailing comment
lattice:
  M_lat = 32
  T_final = 4.0
flags:
  verbose = true
  quiet = false
  name = plain_string
"""


def test_parse_sections(tmp_path):
    p = tmp_path / "t.in"
    p.write_text(TEMPLATE)
    cfg = read_parameter_file(p)
    assert cfg["general"]["method"] == "twolevel"
    assert cfg["lattice"]["M_lat"] == 32
    assert cfg["lattice"]["T_final"] == 4.0
    assert cfg["flags"]["verbose"] is True
    assert cfg["flags"]["quiet"] is False
    assert cfg["flags"]["name"] == "plain_string"


def test_section_typed_access(tmp_path):
    p = tmp_path / "t.in"
    p.write_text(TEMPLATE)
    cfg = read_parameter_file(p)
    lat = Section(cfg, "lattice")
    assert lat.get_int("M_lat", positive=True) == 32
    assert lat.get_float("T_final", positive=True) == 4.0
    with pytest.raises(KeyError):
        lat.get_int("missing")
    with pytest.raises(TypeError):
        lat.get_string("M_lat")
    gen = Section(cfg, "general", defaults={"method": "x", "extra": 7})
    assert gen.get_string("method") == "twolevel"   # file wins
    assert gen.get_int("extra") == 7                # default fills in
    with pytest.raises(ValueError):
        gen.get_string("method", {"singlelevel"})


def test_repo_templates_parse():
    for name in ("parameters_qm_template.in", "parameters_qft_template.in"):
        cfg = read_parameter_file(name)
        assert "general" in cfg and "lattice" in cfg
        assert "parallel" in cfg


def test_bad_line_raises(tmp_path):
    p = tmp_path / "bad.in"
    p.write_text("general:\n  this is not = = valid\n")
    with pytest.raises(ValueError, match="cannot parse"):
        read_parameter_file(p)
    p2 = tmp_path / "orphan.in"
    p2.write_text("key = 1\n")
    with pytest.raises(ValueError, match="outside any section"):
        read_parameter_file(p2)


def test_driver_qm_smoke(tmp_path, capsys):
    """End-to-end driver run on a tiny config (the analog of running the
    driver_qm binary)."""
    cfg = tmp_path / "qm.in"
    cfg.write_text("""
general:
  method = 'singlelevel'
quantummechanics:
  action = 'harmonicoscillator'
lattice:
  M_lat = 8
  T_final = 2.0
harmonicoscillator:
  m0 = 1.0
  mu2 = 1.0
  renormalisation = 'none'
singlelevelmc:
  n_burnin = 20
  n_samples = 600
  epsilon = 1.0E-2
  sampler = 'HMC'
hmc:
  nt = 10
  dt = 0.1
  n_burnin = 10
  n_rep = 1
parallel:
  n_chains = 16
  dtype = 'float64'
""")
    from mlmcpathintegral.drivers.qm import main
    assert main([str(cfg)]) == 0
    out = capsys.readouterr().out
    assert "statistical error" in out
    assert "<x^2> [analytical]" in out


def test_driver_qft_gff_smoke(tmp_path, capsys):
    cfg = tmp_path / "qft.in"
    cfg.write_text("""
general:
  method = 'singlelevel'
quantumfieldtheory:
  action = 'gff'
lattice:
  Mt_lat = 4
  Mx_lat = 4
  coarsening = 'rotate'
gff:
  mass = 2.0
  renormalisation = 'none'
singlelevelmc:
  n_burnin = 10
  n_samples = 400
  epsilon = 1.0E-2
  sampler = 'exact'
parallel:
  n_chains = 16
  dtype = 'float64'
""")
    from mlmcpathintegral.drivers.qft import main
    assert main([str(cfg)]) == 0
    out = capsys.readouterr().out
    assert "<phi^2> [analytical]" in out


def test_driver_qft_sigma_multilevel_blocked(tmp_path, capsys):
    cfg = tmp_path / "sigma.in"
    cfg.write_text("""
general:
  method = 'multilevel'
quantumfieldtheory:
  action = 'nonlinearsigma'
lattice:
  Mt_lat = 4
  Mx_lat = 4
  coarsening = 'rotate'
nonlinearsigma:
  beta = 1.0
  renormalisation = 'none'
parallel:
  n_chains = 8
  dtype = 'float64'
""")
    from mlmcpathintegral.drivers.qft import main
    assert main([str(cfg)]) == 1
    assert "not supported" in capsys.readouterr().out


def test_driver_qm_multilevel_smoke(tmp_path, capsys):
    cfg = tmp_path / "ml.in"
    cfg.write_text("""
general:
  method = 'multilevel'
quantummechanics:
  action = 'harmonicoscillator'
lattice:
  M_lat = 8
  T_final = 2.0
harmonicoscillator:
  m0 = 1.0
  mu2 = 1.0
  renormalisation = 'nonperturbative'
multilevelmc:
  n_level = 2
  n_burnin = 50
  n_samples = 800
  epsilon = 1.0E-2
  show_detailed_stats = true
hierarchical:
  n_max_level = 2
  coarsesampler = 'exact'
parallel:
  n_chains = 16
  dtype = 'float64'
""")
    from mlmcpathintegral.drivers.qm import main
    assert main([str(cfg)]) == 0
    out = capsys.readouterr().out
    assert "Y[1]" in out and "statistical error" in out
