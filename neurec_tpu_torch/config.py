"""Two-level ini + CLI configuration with the reference's lookup semantics.

Behavior parity with the reference Configurator (util/configurator.py:44-157):

* A *library* ini file (e.g. ``NeuRec.properties``) provides global options,
  including ``recommender`` and ``config_dir``; a per-model
  ``<config_dir>/<Recommender>.properties`` provides hyperparameters.
* If an ini file has exactly one section, that section is used regardless of
  name; with several sections the ``default_section`` is required
  (configurator.py:86-94).
* Command-line arguments of the form ``--key=value`` override both files
  (configurator.py:69-78, 97-99).
* Values are coerced with ``eval`` falling back to bool/str
  (configurator.py:129-142).
* Lookup priority on read is lib -> alg -> cmd (configurator.py:116-127).
* ``params_str()`` builds a filesystem-safe run id from the model
  hyperparameters (configurator.py:103-114).
"""

from __future__ import annotations

import os
import sys
from collections import OrderedDict
from configparser import ConfigParser
from typing import Dict, Iterable, Optional


def _coerce(param: str):
    """str -> python value, mirroring configurator.py:129-142."""
    try:
        value = eval(param)  # noqa: S307 - parity with reference semantics
        if not isinstance(value, (str, int, float, list, tuple, bool, type(None))):
            value = param
    except Exception:
        if param.lower() == "true":
            value = True
        elif param.lower() == "false":
            value = False
        else:
            value = param
    return value


def _parse_cmd_args(argv: Iterable[str]) -> "OrderedDict[str, str]":
    cmd_arg: "OrderedDict[str, str]" = OrderedDict()
    for arg in argv:
        if not arg.startswith("--"):
            raise SyntaxError(
                "Command arg must start with '--', but '%s' does not!" % arg
            )
        arg_name, arg_value = arg[2:].split("=", 1)
        cmd_arg[arg_name] = arg_value
    return cmd_arg


class Config:
    """Dict-like configuration object.

    Args:
        config_file: path of the library ini file.
        default_section: section to use when the file has several sections.
        cmd_args: explicit ``["--k=v", ...]`` overrides; when ``None`` the
            process argv is used (skipped under ipykernel, like the reference).
    """

    def __init__(
        self,
        config_file: str,
        default_section: str = "default",
        cmd_args: Optional[Iterable[str]] = None,
    ):
        if not os.path.isfile(config_file):
            raise FileNotFoundError(
                "There is no config file named '%s'!" % config_file
            )
        self._default_section = default_section
        if cmd_args is None:
            cmd_args = [] if "ipykernel_launcher" in sys.argv[0] else sys.argv[1:]
        self.cmd_arg = _parse_cmd_args(cmd_args)
        self.lib_arg = self._read_config_file(config_file)

        config_dir = self.lib_arg.get("config_dir", "./conf")
        model_name = self.lib_arg["recommender"]
        arg_file = os.path.join(config_dir, model_name + ".properties")
        if os.path.isfile(arg_file):
            self.alg_arg = self._read_config_file(arg_file)
        else:
            self.alg_arg = OrderedDict()

    def _read_config_file(self, filename: str) -> "OrderedDict[str, str]":
        config = ConfigParser()
        config.optionxform = str  # preserve key case
        config.read(filename, encoding="utf-8")
        sections = config.sections()
        if len(sections) == 0:
            raise ValueError("'%s' is empty!" % filename)
        elif len(sections) == 1:
            config_sec = sections[0]
        elif self._default_section in sections:
            config_sec = self._default_section
        else:
            raise ValueError(
                "'%s' has more than one section but none named '%s'"
                % (filename, self._default_section)
            )
        config_arg = OrderedDict(config[config_sec].items())
        for arg in self.cmd_arg:
            if arg in config_arg:
                config_arg[arg] = self.cmd_arg[arg]
        return config_arg

    # -- dict-like API -----------------------------------------------------
    def __getitem__(self, item: str):
        if not isinstance(item, str):
            raise TypeError("index must be a str")
        if item in self.lib_arg:
            param = self.lib_arg[item]
        elif item in self.alg_arg:
            param = self.alg_arg[item]
        elif item in self.cmd_arg:
            param = self.cmd_arg[item]
        else:
            raise KeyError("There is no parameter named '%s'" % item)
        return _coerce(param)

    def __getattr__(self, item: str):
        if item.startswith("_") or item in (
            "cmd_arg",
            "lib_arg",
            "alg_arg",
        ):
            raise AttributeError(item)
        try:
            return self[item]
        except KeyError as e:
            raise AttributeError(str(e)) from e

    def __contains__(self, key) -> bool:
        return key in self.lib_arg or key in self.alg_arg or key in self.cmd_arg

    def get(self, key: str, default=None):
        return self[key] if key in self else default

    def get_raw(self, key: str, default=None):
        """Uncoerced string lookup, same lib->alg->cmd priority as ``[]``.

        For filesystem paths: ``_coerce`` runs ``eval()``, so a purely
        numeric path like ``--ckpt_dir=2024-06`` would silently become the
        integer 2018 (ADVICE r2).
        """
        for source in (self.lib_arg, self.alg_arg, self.cmd_arg):
            if key in source:
                return source[key]
        return default

    def params_str(self) -> str:
        """Filesystem-safe run id built from hyperparameters."""
        params_id = "_".join(
            "{}={}".format(arg, value)
            for arg, value in self.alg_arg.items()
            if len(value) < 20
        )
        special_char = {"/", "\\", '"', ":", "*", "?", "<", ">", "|", "\t"}
        params_id = "".join(c if c not in special_char else "_" for c in params_id)
        return "%s_%s" % (self["recommender"], params_id)

    def as_dict(self) -> Dict[str, object]:
        out: Dict[str, object] = {}
        for source in (self.cmd_arg, self.alg_arg, self.lib_arg):
            for key in source:
                out[key] = self[key]
        return out

    def __str__(self) -> str:
        lib_info = "\n".join(
            "{}={}".format(arg, value) for arg, value in self.lib_arg.items()
        )
        alg_info = "\n".join(
            "{}={}".format(arg, value) for arg, value in self.alg_arg.items()
        )
        return "\n\nneurec_tpu hyperparameters:\n%s\n\n%s's hyperparameters:\n%s\n" % (
            lib_info,
            self["recommender"],
            alg_info,
        )

    __repr__ = __str__
