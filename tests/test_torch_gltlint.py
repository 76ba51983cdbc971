"""tools/gltlint over the port: every rule run over ``glt_tpu_torch/``
with an empty baseline finds nothing and fails on no file (what
``python -m tools.gltlint glt_tpu_torch/ --no-baseline`` checks). The
JAX package's baselined and inline-disabled findings are carried into
the port as inline ``# gltlint: disable=`` comments with the same
justification beside them."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools.gltlint.cli import main as gltlint_main  # noqa: E402
from tools.gltlint.core import lint_paths  # noqa: E402


def test_gltlint_finds_nothing_in_the_port():
  result = lint_paths([os.path.join(ROOT, 'glt_tpu_torch')], root=ROOT,
                      baseline={})
  assert not result.errors, result.errors
  assert not result.findings, '\n'.join(
      f'{f.path}:{f.line}: {f.rule} {f.message}' for f in result.findings)
  assert not result.baselined


def test_gltlint_cli_exits_zero_over_the_port(capsys):
  rc = gltlint_main([os.path.join(ROOT, 'glt_tpu_torch'), '--root', ROOT,
                     '--no-baseline', '--quiet'])
  out = capsys.readouterr().out
  assert rc == 0, out
  assert '0 new finding(s)' in out and '0 error(s)' in out
