"""Lightweight metrics / observability.

The reference's only observability is print statements in examples
(SURVEY.md §5). This provides a small stdlib-logging metrics callback for
the quantities that matter to SVGD health — step time, pre-clip ||phi||,
bandwidth h^2, mean log-posterior — with optional CSV capture. No heavy
dependencies."""

import csv
import logging
import time


logger = logging.getLogger("stein_jax")


class MetricsLogger:
    """Collects per-step diagnostics from SVGDSampler.train_on_batch aux.

    Usage:
        metrics = MetricsLogger(log_every=100, csv_path="run.csv")
        for step in ...:
            aux = sampler.train_on_batch(batch)
            metrics.record(step, aux)

    ``resume=True`` appends to an existing CSV instead of truncating it —
    required when paired with the crash-recovery loop (utils/recovery.py),
    where a restart must not lose the pre-crash metric history.
    """

    def __init__(self, log_every=100, csv_path=None, resume=False):
        self.log_every = log_every
        self.csv_path = csv_path
        self.resume = resume
        self._csv_file = None
        self._csv_writer = None
        self._last_time = None
        self._last_step = None
        self.history = []

    def record(self, step, aux):
        # Honest timing columns (r3 review: the old single 'step_time_s'
        # column recorded the INTERVAL between record() calls, which for
        # chunked callers — e.g. examples/production_run.py recording
        # once per checkpoint — was ~chunk_size x the real step time plus
        # checkpoint/eval overhead). interval_s keeps that wall-clock
        # meaning under its real name; avg_step_time_s divides by the
        # recorded step delta (still includes any caller overhead inside
        # the interval — per-step device time belongs to bench.py's
        # slope method, not a host-side logger).
        now = time.perf_counter()
        step = int(step)
        interval = None if self._last_time is None else now - self._last_time
        avg_step = (
            interval / (step - self._last_step)
            if interval is not None and self._last_step is not None
            and step > self._last_step else None
        )
        self._last_time = now
        self._last_step = step
        from .hostio import host_scalar
        row = {
            "step": step,
            "interval_s": interval,
            "avg_step_time_s": avg_step,
            "phi_norm": host_scalar(aux["phi_norm"]),
            "h2": host_scalar(aux["h2"]),
            "log_p_mean": (host_scalar(aux["log_p_mean"])
                           if "log_p_mean" in aux else float("nan")),
        }
        self.history.append(row)
        if self.csv_path is not None:
            if self._csv_writer is None:
                import os
                append = (
                    self.resume
                    and os.path.exists(self.csv_path)
                    and os.path.getsize(self.csv_path) > 0
                )
                if append:
                    # DictWriter appends values positionally: a stale file
                    # with different columns would silently misalign every
                    # appended row — refuse instead.
                    with open(self.csv_path, newline="") as f:
                        header = f.readline().strip().split(",")
                    if header != list(row):
                        raise ValueError(
                            f"cannot resume metrics CSV {self.csv_path}: "
                            f"existing header {header} != current fields "
                            f"{list(row)} (delete the file or use a new "
                            "path)"
                        )
                self._csv_file = open(
                    self.csv_path, "a" if append else "w", newline=""
                )
                self._csv_writer = csv.DictWriter(
                    self._csv_file, fieldnames=list(row)
                )
                if not append:
                    self._csv_writer.writeheader()
            self._csv_writer.writerow(row)
            self._csv_file.flush()
        if self.log_every and step % self.log_every == 0:
            logger.info(
                "step=%d phi_norm=%.4g h2=%.4g log_p_mean=%.6g interval=%s",
                row["step"], row["phi_norm"], row["h2"], row["log_p_mean"],
                f"{interval:.4f}s" if interval is not None else "n/a",
            )

    def close(self):
        if self._csv_file is not None:
            self._csv_file.close()
            self._csv_file = None
            self._csv_writer = None
