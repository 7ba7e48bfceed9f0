import os
import sys

import pytest

# Tests run on the CPU backend split into 8 virtual devices, so that the
# sharding paths run without a multi-GPU host. `--device gpu` sends the
# golden lane's CLI runs (tests/test_golden_parity.py) to the GPU and
# enables the tests marked `gpu`.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# in case a plugin imported jax before the variable was set
jax.config.update("jax_platforms", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def pytest_addoption(parser):
    parser.addoption(
        "--device", choices=("cpu", "gpu"), default="cpu",
        help="where the golden lane's CLI runs go, and whether tests "
             "marked gpu run (default: cpu)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; runs only with --device gpu")


@pytest.fixture(scope="session")
def device(request) -> str:
    return request.config.getoption("--device")


@pytest.fixture(autouse=True)
def _gpu_only(request, device):
    if request.node.get_closest_marker("gpu") and device != "gpu":
        pytest.skip("needs a GPU: run with --device gpu on a GPU host")


@pytest.fixture(scope="session")
def cli_env(device) -> dict:
    """Environment of a CLI subprocess: the CPU, or (``--device gpu``)
    the default platform choice, which requires the GPU."""
    env = dict(os.environ,
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    if device == "gpu":
        env.pop("JAX_PLATFORMS", None)
    return env
