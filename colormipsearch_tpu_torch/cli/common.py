"""Shared CLI argument-surface helpers.

The reference injects one CommonArgs delegate into every command
(cmd/AbstractCmdArgs.java:15-17 pulls cmd/CommonArgs.java:13-31 into
each args class), so every subcommand accepts
``--outputDir/--output-dir/-od``,
``--cdsConcurrency/--task-concurrency/-tc/-cdc``,
``--no-pretty-print``, ``--results-storage`` and ``--config``.
:func:`ensure_common_args` gives our argparse subcommands the same
guarantee no matter which of those options their configure function
already declared.
"""

from __future__ import annotations

import argparse

# canonical CommonArgs groups: (all reference option strings, kwargs
# used when a subcommand declares none of them)
_COMMON_GROUPS = [
    (("-od", "--outputDir", "--output-dir"),
     dict(dest="outputDir", default=None, metavar="DIR",
          help="output directory")),
    (("--cdsConcurrency", "--task-concurrency", "-tc", "-cdc"),
     # SUPPRESS so a value given before the subcommand (the global
     # --cdsConcurrency) is not clobbered by this default
     dict(dest="cdsConcurrency", type=int, default=argparse.SUPPRESS,
          metavar="N", help="task/decode concurrency")),
    (("--no-pretty-print",),
     dict(dest="noPrettyPrint", action="store_true",
          help="do not pretty print JSON results")),
    (("--results-storage",),
     dict(dest="resultsStorage", choices=["FS", "DB"], default="FS",
          help="results storage backend")),
    (("--config",),
     dict(dest="configFile", default=None, metavar="FILE",
          help="properties file for the DB storage backend")),
]


def ensure_common_args(sp: argparse.ArgumentParser) -> None:
    """Make ``sp`` accept the full CommonArgs surface: add any group the
    configure function didn't declare, and graft missing aliases onto
    the action it did declare (so e.g. a command with ``--outputDir``
    also takes ``--output-dir``)."""
    for names, kwargs in _COMMON_GROUPS:
        actions = [sp._option_string_actions.get(n) for n in names]
        action = next((a for a in actions if a is not None), None)
        if action is None:
            sp.add_argument(*names, **kwargs)
            continue
        for name, existing in zip(names, actions):
            if existing is None:
                action.option_strings.append(name)
                sp._option_string_actions[name] = action


def add_gradient_selector_args(sp: argparse.ArgumentParser) -> None:
    """The gradientScores DataSource selector family
    (cmd/AbstractGradientScoresArgs.java:18-96): scopes which masks are
    rescored, which of their matches qualify (by target neuron), and
    which match records are read. They select only on the DB storage
    backend, which the port does not have yet; with FS storage the
    match files name what is scored."""
    sp.add_argument("--alignment-space", "-as", dest="alignmentSpace",
                    default=None,
                    help="alignment space of the masks/targets")
    sp.add_argument("--masks-published-names", nargs="*", default=[],
                    help="mask published names to select for scoring")
    sp.add_argument("--masks-mips", nargs="*", default=[],
                    help="selected mask MIP ids")
    sp.add_argument("--masks-datasets", nargs="*", default=[])
    sp.add_argument("--masks-tags", nargs="*", default=[])
    sp.add_argument("--masks-terms", nargs="*", default=[],
                    help="terms (annotations) required on the mask")
    sp.add_argument("--excluded-masks-terms", nargs="*", default=[])
    sp.add_argument("--masks-processing-tags", nargs="*", default=[],
                    metavar="NAME:V1;V2",
                    help="mask processing-tag selectors "
                         "(NameValueArg 'type:tag1;tag2' form)")
    sp.add_argument("--targets-libraries", nargs="*", default=[])
    sp.add_argument("--targets-published-names", nargs="*", default=[])
    sp.add_argument("--targets-mips", nargs="*", default=[])
    sp.add_argument("--targets-datasets", nargs="*", default=[])
    sp.add_argument("--targets-tags", nargs="*", default=[])
    sp.add_argument("--targets-terms", nargs="*", default=[])
    sp.add_argument("--excluded-targets-terms", nargs="*", default=[])
    sp.add_argument("--targets-processing-tags", nargs="*", default=[],
                    metavar="NAME:V1;V2")
    sp.add_argument("--match-tags", nargs="*", default=[],
                    help="only score match records carrying one of "
                         "these tags")
