"""Interop with other ML libraries (paper §2.1 "integration"), the port's
copy of ``repro.interop``: import externally-trained forests into the
compiled serving stack."""
from repro_torch.interop.sklearn import from_sklearn  # noqa: F401
