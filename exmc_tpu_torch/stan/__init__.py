"""Stan-subset frontend of the port (``exmc_tpu/stan``; reference
lib/exmc/stan.ex + src/exmc_stan_{lexer.xrl,parser.yrl}).

A pure-Python tokenizer and recursive-descent parser (copies of the JAX
package's, the same tokens and AST) and a compiler from the AST to the
port's IR: expressions in distribution arguments, ``target +=`` (with
``_lpdf``/``_lpmf`` calls), compile-time-vectorized ``for`` loops,
inlined ``functions`` with locals, ``transformed data`` /
``transformed parameters``, matrix data and parameters, bounded,
data-referencing and affine (``<offset=, multiplier=>``) constraints,
ordered / positive_ordered / cholesky_factor_corr / sum_to_zero_vector
types, 26 mapped distributions, and ``generated quantities`` evaluated
per posterior draw after sampling. ``while`` loops are rejected."""

from exmc_tpu_torch.stan.frontend import (
    StanSyntaxError,
    compile as compile,
    compile_or_error,
    generated_quantities,
    sample,
)

__all__ = ["compile", "compile_or_error", "generated_quantities",
           "sample", "StanSyntaxError"]
