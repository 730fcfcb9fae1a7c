"""Bash script generation for experiment batches.

Counterpart of ``sgmcmc_tpu/experiments/script_builder.py``: writes one
driver line per experiment into k split shell scripts with tee'd logs,
plus a chained runner.  The port's driver lines run the module
``python -m sgmcmc_tpu_torch.experiments.driver ...``.
"""
from __future__ import annotations

import os
import shlex
import stat

from ..io.checkpoint import make_path


def _write_script(path: str, lines: list[str]) -> str:
    with open(path, "w") as f:
        f.write("#!/bin/bash\n")
        f.write("set -u\n")
        for line in lines:
            f.write(line + "\n")
    os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)
    return path


def _invocation(python_script_path: str) -> str:
    """``python``'s argument for a script path (``*.py``) or a module
    name (run with ``-m``)."""
    if python_script_path.endswith(".py"):
        return shlex.quote(python_script_path)
    return f"-m {shlex.quote(python_script_path)}"


def args_to_cli(arg_dict: dict) -> str:
    parts = []
    for k, v in arg_dict.items():
        if isinstance(v, bool):
            if v:
                parts.append(f"--{k}")
        elif isinstance(v, (list, tuple)):
            parts.append(f"--{k} " + " ".join(shlex.quote(str(x))
                                              for x in v))
        else:
            parts.append(f"--{k} {shlex.quote(str(v))}")
    return " ".join(parts)


def script_builder(script_name: str, python_script_path: str,
                   python_script_args: list[dict], path_to_shell_script: str,
                   script_splits: int = 1, project_root: str | None = None,
                   conda_env_name: str | None = None) -> list[str]:
    """Split experiment arg-dicts into ``script_splits`` shell scripts;
    ``python_script_path`` is a ``*.py`` path or a module name."""
    make_path(path_to_shell_script)
    log_dir = make_path(os.path.join(path_to_shell_script, "logs"))
    scripts = []
    n = len(python_script_args)
    per = -(-n // script_splits) if n else 0
    for s in range(script_splits):
        chunk = python_script_args[s * per:(s + 1) * per]
        lines = []
        if project_root:
            lines.append(f"cd {shlex.quote(project_root)}")
        if conda_env_name:
            lines.append(f"conda activate {shlex.quote(conda_env_name)}")
        for i, args in enumerate(chunk):
            log = os.path.join(log_dir, f"{script_name}_{s}_{i}.log")
            lines.append(
                f"python {_invocation(python_script_path)} "
                f"{args_to_cli(args)} 2>&1 | tee {shlex.quote(log)}")
        scripts.append(_write_script(
            os.path.join(path_to_shell_script,
                         f"{script_name}_script_{s}.sh"), lines))
    return scripts


def chain_scripts(name: str, script_paths: list[str],
                  path_to_shell_script: str) -> str:
    """run_all.sh-style chained runner."""
    lines = [f"bash {shlex.quote(p)}" for p in script_paths]
    return _write_script(os.path.join(path_to_shell_script, f"{name}.sh"),
                         lines)


class TqdmToLogger:
    """Output stream routing tqdm progress lines into ``logging``: pass as
    ``tqdm(..., file=TqdmToLogger(logger))`` in batch jobs whose stdout
    is tee'd to a log file, so progress lines become log records instead
    of carriage-return spam."""

    def __init__(self, logger, level=None):
        import logging
        self.logger = logger
        self.level = logging.INFO if level is None else level
        self.buf = ""

    def write(self, buf: str) -> None:
        self.buf = buf.strip("\r\n\t ")

    def flush(self) -> None:
        if self.buf:
            self.logger.log(self.level, self.buf)
