r"""The port's public surface as it grows: every name ported so far exists
in ``zuko_tpu_torch`` under the module of its ``zuko_tpu`` counterpart, is
exported by it, and is a public name of that counterpart (its ``__all__``).
The table grows with the port; a name the port adds of its own (a kernel's
wrapper, the weight bridge's rename table) does not stand in it.
"""

import importlib

import pytest

# module (relative to either package) -> the names ported so far
PORTED = {
    "utils": ["bisection", "broadcast", "gauss_legendre", "newton_bisection", "odeint", "unpack"],
    "nn": [
        "Activation", "LayerNorm", "Linear", "MLP", "MaskedLinear", "MaskedMLP", "MonotonicLinear",
        "MonotonicMLP", "Residual", "TwoWayELU",
    ],
    "transforms": [
        "AdditiveTransform", "AutoregressiveTransform", "BernsteinTransform",
        "BoundedBernsteinTransform", "CircularShiftTransform", "ComposedTransform",
        "DependentTransform", "FreeFormJacobianTransform", "GaussianizationTransform", "Inverse",
        "MonotonicAffineTransform", "MonotonicRQSTransform", "MonotonicTransform",
        "RotationTransform", "SOSPolynomialTransform", "SoftclipTransform", "Transform",
        "UnconstrainedMonotonicTransform",
    ],
    "distributions": ["BoxUniform", "DiagNormal", "Distribution", "NormalizingFlow"],
    "lazy": [
        "Flow", "LazyComposedTransform", "LazyDistribution", "LazyInverse", "LazyTransform",
        "UnconditionalDistribution", "UnconditionalTransform",
    ],
    "flows": [
        "BPF", "CNF", "ElementWiseTransform", "FFJTransform", "Flow", "GF", "MAF", "MNN",
        "MaskedAutoregressiveTransform", "NAF", "NCSF", "NSF", "SOSPF", "UMNN", "UNAF",
    ],
    "flows.autoregressive": ["MAF", "MaskedAutoregressiveTransform"],
    "flows.spline": ["CircularRQSTransform", "NCSF", "NSF"],
    "flows.polynomial": ["BPF", "SOSPF", "ShiftedSOSPTransform"],
    "flows.gaussianization": ["ElementWiseTransform", "GF"],
    "flows.neural": ["MNN", "NAF", "UMNN", "UNAF"],
    "flows.continuous": ["CNF", "FFJTransform"],
    "serial": ["load_params"],
    "data": ["ring_energy", "two_moons"],
    "parallel": ["TrainState", "make_mle_step", "make_reverse_kl_step", "train_mle"],
    "parallel.train": ["TrainState", "make_mle_step", "make_reverse_kl_step", "train_mle"],
    "ops.nsf_fused": [
        "FusedStructureError", "extract_nsf_params", "fused_nsf_log_prob", "fused_nsf_sample"],
    "ops.gf_fused": ["extract_gf_params", "fused_gf_log_prob", "fused_gf_sample"],
    "ops.naf_fused": ["extract_naf_params", "fused_naf_log_prob", "fused_naf_sample"],
    "ops.cnf_fused": [
        "extract_cnf_params", "fused_cnf_log_prob", "fused_cnf_rsample", "fused_cnf_sample"],
    "ops.ift": [
        "fused_gf_rsample", "fused_gf_rsample_and_log_prob", "fused_naf_rsample",
        "fused_naf_rsample_and_log_prob", "fused_nsf_rsample", "fused_nsf_rsample_and_log_prob",
    ],
    "ops.dispatch": [
        "FusedAutoregressiveFlow", "FusedContinuousFlow", "FusedDensityFlow",
        "FusedGaussianizationFlow",
        "FusedInvertedAutoregressiveFlow", "FusedNeuralSamplingFlow", "fused_dispatch_enabled",
        "maybe_fused_flow",
    ],
    "ops.masked_linear": ["masked_linear"],
    "ops.rqs": ["rqs_forward", "rqs_inverse"],
}


@pytest.mark.parametrize("module", list(PORTED))
def test_ported_names_exist_in_both_packages(module):
    port = importlib.import_module(f"zuko_tpu_torch.{module}")
    reference = importlib.import_module(f"zuko_tpu.{module}")
    for name in PORTED[module]:
        assert name in port.__all__, f"zuko_tpu_torch.{module} does not export {name}"
        assert getattr(port, name) is not None
        assert name in reference.__all__, f"zuko_tpu.{module} has no public {name}"
        assert callable(getattr(reference, name))


def test_the_table_covers_what_the_port_shares_with_zuko_tpu():
    """A name exported by a port module and by its counterpart stands in
    the table: a change that ports a name also lists it."""
    for module, names in PORTED.items():
        port = importlib.import_module(f"zuko_tpu_torch.{module}")
        reference = importlib.import_module(f"zuko_tpu.{module}")
        shared = set(port.__all__) & set(reference.__all__)
        assert shared == set(names), (module, sorted(shared ^ set(names)))
