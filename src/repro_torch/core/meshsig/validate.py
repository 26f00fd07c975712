"""Mesh-signature validation (port of ``repro.core.meshsig.validate``):
the paper's §6.2.2 accuracy experiment in the mesh domain.

Profile two meshes (32 x 8 and 64 x 4), fit the signature, predict the
per-axis collective link bytes of meshes it has not seen, then profile
those meshes too and compare.  Errors are reported the paper's way:
|predicted - measured| as a percentage of the run's total link traffic,
beside the advisor's ranking of the unseen meshes.

The reference compiles each mesh's step on up to 256 fake devices and
reads the HLO; here each mesh is rank 0 of a layout-only mesh of those
sizes, its step run on ``meta`` tensors through the port's counter
source (``launch.dryrun.profile_cell``), in one process with no
environment to set.  Run as a script (the record goes under ``--out``,
``build/dryrun`` by default)::

    PYTHONPATH=src python -m repro_torch.core.meshsig.validate --arch llama3-8b
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, get_config
from repro_torch.core.meshsig.advisor import CHIP_V5E, ChipSpec, rank_meshes
from repro_torch.core.meshsig.fit import (
    MeshProfile,
    MeshSignature,
    fit_mesh_signature,
    profile_from_analysis,
)
from repro_torch.parallel import context as ctx

# Adaptation finding (the reference's): unlike the NUMA domain, a
# *symmetric* mesh profile cannot attribute group-size-k collectives to an
# axis when both axes have size k, so BOTH profiling runs are asymmetric
# (they play the roles of the paper's two runs: two placements that
# jointly identify every signature parameter).
FIT_MESHES = [{"data": 32, "model": 8}, {"data": 64, "model": 4}]
VAL_MESHES = [{"data": 8, "model": 32}, {"data": 4, "model": 64}, {"data": 16, "model": 16}]


def measured_axis_bytes(prof: MeshProfile) -> dict[str, float]:
    """Collapse a profile's (class, axis) link bytes to per-axis totals —
    the measured counterpart of ``sig.predict_axis_bytes``."""
    meas = {a: 0.0 for a in prof.axis_sizes}
    for (_, a), v in prof.class_axis_bytes.items():
        meas[a] += v
    return meas


def prediction_errors(
    sig: MeshSignature, axes: dict[str, int], meas: dict[str, float]
) -> dict[str, float]:
    """Per-axis |predicted - measured| as % of the run's total link
    traffic (the paper's §6.2.2 metric).  Distinct axis sizes attribute
    measurements exactly; a symmetric mesh only identifies the total."""
    pred = sig.predict_axis_bytes(axes)
    total = sum(meas.values()) or 1.0
    if len(set(axes.values())) == len(axes):
        return {a: abs(pred.get(a, 0.0) - meas[a]) / total * 100 for a in axes}
    return {"total": abs(sum(pred.values()) - total) / total * 100}


def mesh_name(axes: dict[str, int]) -> str:
    return "x".join(str(v) for v in axes.values())


def profile_mesh(cfg: ModelConfig, shape: ShapeConfig, axes: dict) -> tuple[MeshProfile, float]:
    """Rank 0's profile of a cell's step on a layout-only mesh of
    ``axes`` (names to sizes), and the seconds it took."""
    from repro_torch.launch.dryrun import profile_cell

    mesh = ctx.Mesh(tuple(axes), tuple(axes.values()), 0)
    counters, _ = profile_cell(cfg, shape, mesh)
    return profile_from_analysis(counters, axes), counters.seconds


def run_validation(
    arch: str = "llama3-8b",
    shape_name: str = "train_4k",
    *,
    chip: ChipSpec = CHIP_V5E,
    fit_meshes: list[dict] = FIT_MESHES,
    val_meshes: list[dict] = VAL_MESHES,
) -> dict:
    """The reference's record: the signature fitted on ``fit_meshes``
    (its class fractions and terms), each of ``val_meshes`` predicted and
    measured (a mesh the port's cuts refuse is recorded with its error),
    the median and largest errors and the advisor's order of the
    validation meshes beside their measured order.  ``fit_meshes_check``
    adds the same comparison on the fit meshes themselves."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    record: dict = {"arch": arch, "shape": shape_name, "meshes": {}}

    sym, t_sym = profile_mesh(cfg, shape, fit_meshes[0])
    asym, t_asym = profile_mesh(cfg, shape, fit_meshes[1])
    sig = fit_mesh_signature(sym, asym)
    # the reference's keys; no compile happens, they hold the profiles' seconds
    record["fit_compile_s"] = round(t_sym + t_asym, 1)
    record["class_fractions"] = sig.class_fractions()
    record["terms"] = {
        f"{cls}/{axis}": {"beta": beta, "e": e}
        for (cls, axis), (beta, e) in sig.terms.items()
    }
    record["fit_meshes_check"] = {}
    for axes, prof in zip(fit_meshes, (sym, asym)):
        meas = measured_axis_bytes(prof)
        record["fit_meshes_check"][mesh_name(axes)] = {
            "predicted_axis_bytes": sig.predict_axis_bytes(axes),
            "measured_axis_bytes": meas,
            "error_pct_of_total": prediction_errors(sig, axes, meas),
        }

    errors = []
    actual_times = {}
    for axes in val_meshes:
        name = mesh_name(axes)
        try:
            prof, t = profile_mesh(cfg, shape, axes)
        except Exception as e:  # a candidate the port's cuts refuse; record it
            record["meshes"][name] = {"error": f"{type(e).__name__}: {e}"[:300]}
            continue
        pred = sig.predict_axis_bytes(axes)
        meas = measured_axis_bytes(prof)
        mesh_errs = prediction_errors(sig, axes, meas)
        errors.extend(mesh_errs.values())
        actual_times[name] = sum(meas.values())
        record["meshes"][name] = {
            "predicted_axis_bytes": pred,
            "measured_axis_bytes": meas,
            "error_pct_of_total": mesh_errs,
            "compile_s": round(t, 1),
        }

    errors.sort()
    record["median_error_pct"] = errors[len(errors) // 2] if errors else None
    record["max_error_pct"] = errors[-1] if errors else None

    # Advisor ranking vs measured total link bytes on the validation meshes
    rankings = rank_meshes(sig, val_meshes, chip=chip)
    record["advisor_order"] = [mesh_name(r.axis_sizes) for r in rankings]
    record["measured_order"] = sorted(actual_times, key=actual_times.get)
    return record


def main() -> None:
    from repro_torch.launch.dryrun import DEFAULT_OUT

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT, help="record directory")
    args = ap.parse_args()
    rec = run_validation(args.arch, args.shape)
    args.out.mkdir(parents=True, exist_ok=True)
    out = args.out / f"meshsig_validation__{args.arch}__{args.shape}.json"
    out.write_text(json.dumps(rec, indent=1, default=str))
    print(json.dumps({k: rec[k] for k in (
        "arch", "shape", "class_fractions", "median_error_pct",
        "max_error_pct", "advisor_order", "measured_order") if k in rec},
        indent=1, default=str))


if __name__ == "__main__":
    main()
