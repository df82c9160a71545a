"""Rule modules — importing this package registers every rule.

Adding a rule: create a module here (or extend one), subclass
:class:`~..core.Rule`, set ``id``/``name``/``description``, implement
``check_module`` (one file at a time) and/or ``check_project`` (cross-module
invariants), decorate with ``@register``, and import the module below. See
README "Static analysis" for a worked example.
"""

from . import (  # noqa: F401  (import for registration side effect)
    compat,
    concurrency,
    copies,
    determinism,
    dispatch,
    graph,
    jit_purity,
    lockorder,
    meshrules,
    obs,
    ownership,
    padding,
    persistence,
    placement,
    protocol,
    purity,
    resources,
    sharedstate,
    tunables,
    wireproto,
)
