def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one "
        "(run on the H100: python -m pytest -m cuda "
        "tests/test_torch_kernels.py)")
