"""The import check: top-level names compared whole."""
import subprocess
import sys
import types

from benchmark.harness import main, spec


def test_port_is_allowed_and_jax_names_are_not(monkeypatch):
    monkeypatch.setitem(sys.modules, "sgmcmc_tpu_torch_fake",
                        types.ModuleType("sgmcmc_tpu_torch_fake"))
    assert "sgmcmc_tpu_torch" not in main.forbidden_modules()
    import sgmcmc_tpu_torch  # noqa: F401
    assert main.forbidden_modules() == []
    for name in ("sgmcmc_tpu", "sgmcmc_tpu.ops", "jax", "jaxlib.xla",
                 "flax.linen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert main.forbidden_modules() == ["flax", "jax", "jaxlib",
                                        "sgmcmc_tpu"]


def test_run_imports_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.harness.main, benchmark.harness.cell, "
            "benchmark.calibrate, sgmcmc_tpu_torch.inference.samplers, "
            "sgmcmc_tpu_torch.parallel.training; "
            "from benchmark.harness import main; "
            "print(main.forbidden_modules())" % str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.fit, benchmark.reference.svm, "
            "benchmark.reference.garch; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('sgmcmc_tpu_torch', 'sgmcmc_tpu', "
            "'jax')))" % str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"
