"""Settings of the benchmark's own tests (run them with ``python -m pytest portbench/tests``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; each such test skips itself without one"
    )
