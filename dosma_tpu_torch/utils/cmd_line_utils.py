"""Command-line action metadata (counterpart of ``dosma_tpu/utils/cmd_line_utils.py``)."""

from __future__ import annotations

from typing import Dict, List, Optional

__all__ = ["ActionWrapper"]


class ActionWrapper:
    """Metadata wrapper for scan methods exposed on the command line.

    Holds the action name, help string, per-parameter help, parameter
    aliases, and action aliases — consumed by the reflection CLI
    (the CLI) when building subparsers.
    """

    def __init__(
        self,
        name: str,
        help: str = "",
        param_help: Optional[Dict[str, str]] = None,
        alternative_param_names: Optional[Dict[str, List[str]]] = None,
        aliases: Optional[List[str]] = None,
    ):
        self._name = name
        self._help = help
        self._aliases = list(aliases) if aliases else []

        if param_help is not None:
            assert isinstance(param_help, dict)
            for k, v in param_help.items():
                assert isinstance(k, str) and isinstance(v, str)
        self._param_help = dict(param_help) if param_help else None

        if alternative_param_names is not None:
            assert isinstance(alternative_param_names, dict)
            for k, v in alternative_param_names.items():
                assert isinstance(k, str) and isinstance(v, (list, tuple))
        self._alternative_param_names = (
            dict(alternative_param_names) if alternative_param_names else None
        )

    def get_alternative_param_names(self, param: str) -> Optional[List[str]]:
        if self._alternative_param_names and param in self._alternative_param_names:
            return list(self._alternative_param_names[param])
        return None

    def get_param_help(self, param: str) -> str:
        if self._param_help and param in self._param_help:
            return self._param_help[param]
        return ""

    @property
    def name(self) -> str:
        return self._name

    @property
    def help(self) -> str:
        return self._help

    @property
    def aliases(self) -> List[str]:
        return self._aliases
