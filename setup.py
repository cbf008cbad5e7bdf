"""Package build for incubator_mxnet_tpu (ref tools/pip/setup.py — the
reference's staticbuild wheel; here the native layer is two small g++
libraries compiled at build time instead of a vendored BLAS/CUDA stack).

`python setup.py sdist bdist_wheel` produces an installable wheel whose
package data includes libmxtpu.so (RecordIO/JPEG pipeline) and
libmxtpu_predict.so (embedded-interpreter predict + imperative-invoke C
ABI), both rebuilt from native/src/*.cc by the custom build step. Set
MXTPU_SKIP_NATIVE_BUILD=1 to package without a toolchain (the Python
tiers still work; IO falls back, bindings need the .so)."""
import os
import sys

from setuptools import setup, find_packages
from setuptools.command.build_py import build_py
from setuptools.dist import Distribution


class BuildWithNative(build_py):
    def run(self):
        if not os.environ.get("MXTPU_SKIP_NATIVE_BUILD"):
            sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
            from incubator_mxnet_tpu.native import lib as native_lib
            native_lib.build(force=True)
            native_lib.build_predict(force=True)
        super().run()


class BinaryDistribution(Distribution):
    """The bundled .so files are platform/arch-specific: force a platform
    wheel tag (a py3-none-any wheel would install-but-break elsewhere)."""

    def has_ext_modules(self):
        return not os.environ.get("MXTPU_SKIP_NATIVE_BUILD")


setup(
    name="incubator-mxnet-tpu",
    version="0.1.0",
    description="TPU-native framework with MXNet capability parity "
                "(JAX/XLA/Pallas compute, C++ IO/runtime)",
    packages=find_packages(include=["incubator_mxnet_tpu",
                                    "incubator_mxnet_tpu.*",
                                    "incubator_mxnet_tpu_torch",
                                    "incubator_mxnet_tpu_torch.*"]),
    package_data={"incubator_mxnet_tpu.native": ["*.so", "src/*.cc"],
                  "incubator_mxnet_tpu_torch.ops": ["csrc/*.cu", "csrc/*.cpp"],
                  "incubator_mxnet_tpu_torch.native": [
                      "src/*.cc", "third_party/libjpeg/*.h",
                      "third_party/PROVENANCE.md"]},
    include_package_data=True,
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
    cmdclass={"build_py": BuildWithNative},
    distclass=BinaryDistribution,
)
