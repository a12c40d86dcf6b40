"""Statistics of the analysis state.

Counterpart of beast_mcmc_tpu/config/xml_stats.py, its `_current_state`
only (the initial state with the derived parameters overlaid, which the
transformed, masked and vector-sum views of config/xml_ext.py read at
parse time). The module's statistics vocabulary stays with ROADMAP queue
item 5c: each of its tags raises Unsupported in the interpreter
(config/interpreter.py EXTENSION_TAGS).
"""

from __future__ import annotations

from beast_mcmc_tpu_torch.config.interpreter import XmlAnalysis


def _current_state(ax: XmlAnalysis):
    """(params, tree) at the document's initial values, the derived
    parameters injected."""
    from beast_mcmc_tpu_torch.config.xml_assert import initial_eval_state

    params0, tree0 = initial_eval_state(ax)
    return ax.inject_derived(params0), tree0
