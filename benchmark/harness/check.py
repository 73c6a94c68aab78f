"""What decides `correct`: the port's outputs in the window, held
against the plain reference (``reference.run3d``) in float64.

The probe keeps, of the window's first cycle, step 0 and one step `j`
drawn from the seed (see `probe.Capture`).  The numbers compared:

``start``
    The state the driver hands its first evolve3d call (density after
    reading, unit conversion and rescaling; the fractions from the
    restart cubes; the temperature) against the reference's, worked out
    from the same files.
``sources``
    The source lists of steps 0 and j (positions exact, photon rates)
    against the reference's catalog, suppression and luminosities.
``rates_first``
    The first iteration of step 0: the summed rate grids and the
    photon and LLS losses of all sources, against the reference's sweep
    from its own initial state, at the subbox radius the port chose.
``chem_first``
    That iteration's chemistry: the port's state after it against the
    reference's chemistry pass from its own state and its own rates.
``slabs_last``
    The last iteration of step j: the rate slab and losses of each
    sampled source against the reference's trace of that source, from
    the state the port started the iteration with.
``chem_last``
    That iteration's chemistry from the port's state and rates, and the
    step's output state (the converged fractions promoted).
``not_finite``
    How many of the values judged are not numbers (an exact count: the
    limit is 0); each such value also counts, in its own number, as
    wrong as its kind can be.
``budget``
    Step j's photon budget (ionizations, recombinations, collisional
    ionizations, photons emitted, as shares of the photons emitted, and
    the conservation ratio) from the port's states at the step's start
    and end.

Rates, densities and temperatures are compared by the relative L2 norm
of the difference, each channel and field on its own scale, the
photo-ionization rates per atom weighted by the density of the atoms
they ionize (`absorbers`); ionization fractions by the root mean square
of the difference.  In the control, a `Reference` in a
lower precision is put in the port's place and its outputs are judged
the same way.
"""

import math

import torch

from reference.plain import constants as const

RATE_CHANNELS = ("phih", "phihe0", "phihe1", "phiheat")
START_FIELDS = ("ndens", "h1", "he1", "he2", "t_final")
CHEM_FIELDS = ("h_av0", "h_av1", "he_av0", "he_av1", "he_av2", "h_int0",
               "h_int1", "he_int0", "he_int1", "he_int2", "t_av", "t_inter")
OUT_FIELDS = ("h0", "h1", "he0", "he1", "he2", "t_final")
BUDGET_TERMS = ("total_ion", "totrec", "totcollisions", "recomions",
                "total_src")


def _f64(a, b):
    f = lambda x: (x.double() if torch.is_tensor(x) else
                   torch.as_tensor(x, dtype=torch.float64)).reshape(-1)
    a = f(a)
    return a, f(b).to(a.device)


def _finite(v: float) -> float:
    """A reading that is not a number fails: it reads as infinite."""
    return v if v == v else math.inf


def _diff(a, b, worst):
    """a - b, where `a` is not a number the difference `worst`: such a
    cell counts as wrong as its kind can be (the `not_finite` number
    counts it too)."""
    d = a - b
    return torch.where(torch.isfinite(a), d, torch.full_like(d, worst))


def rel(a, b) -> float:
    """||a - b|| / ||b|| in float64 (0 when both are 0); a value that is
    not a number differs by the largest |b|."""
    a, b = _f64(a, b)
    worst = float(b.abs().max()) if b.numel() else 0.0
    num = float(torch.linalg.vector_norm(_diff(a, b, worst)))
    den = float(torch.linalg.vector_norm(b))
    if den == 0.0:
        return 0.0 if num == 0.0 else math.inf
    return _finite(num / den)


def rms(a, b) -> float:
    """The root mean square of a - b in float64: fractions, which lie in
    [0, 1], on that absolute scale (a neutral fraction near 0 is the
    difference of 1 and the ionized one, and carries the ionized one's
    rounding)."""
    a, b = _f64(a, b)
    return _finite(float(torch.linalg.vector_norm(_diff(a, b, 1.0)))
                   / math.sqrt(a.numel()))


# the species each photo-ionization channel ionizes, with its abundance
# weight: (fraction field of the state the sweep read, H or He)
_ABSORBER = {"phih": ("h_av0", "h"), "phihe0": ("he_av0", "he"),
             "phihe1": ("he_av1", "he")}


def absorbers(state) -> dict:
    """Per channel, the density of the species it ionizes in each cell
    (n x abundance x fraction, the fraction floored at 1e-20 as the
    sweep floors it): a rate per atom times it is the ionizations per
    unit volume, which is what the chemistry and the budget take.  A
    channel's rate per atom of a species that is absent (HeII in a
    neutral cell) is the thin-limit quotient of two vanishing numbers,
    carries no ionization, and in float32 rounds to anything; weighted,
    it counts for as little as it does in the physics."""
    nd = state.ndens.double()
    out = {}
    for ch, (field, el) in _ABSORBER.items():
        x = torch.clamp(getattr(state, field).double(), min=1.0e-20)
        abu = const.abu_he if el == "he" else 1.0 - const.abu_he
        out[ch] = nd * x * abu
    return out


def _is_fraction(key: str) -> bool:
    name = key.rsplit(".", 1)[-1].removeprefix("out_")
    return name.startswith(("h0", "h1", "he0", "he1", "he2", "h_av", "h_int",
                            "he_av", "he_int"))


def _fields(x, names):
    return {n: getattr(x, n) for n in names}


def _worst(pairs, detail=None, tag="") -> float:
    vals = []
    for key, a, b in pairs:
        v = rms(a, b) if _is_fraction(key) else rel(a, b)
        vals.append(v)
        if detail is not None:
            detail[f"{tag}.{key}"] = v
            if torch.is_tensor(a) and not bool(torch.isfinite(a).all()):
                detail[f"{tag}.{key}.cells_not_finite"] = int(
                    (~torch.isfinite(a)).sum())
    return max(vals) if vals else 0.0


class Judged:
    """The outputs to judge, from the port's records (`from_port`) or
    from a reference put in its place (`from_control`)."""

    @staticmethod
    def from_port(records, start, last, flux_scale, sample):
        r0, rj = records[start], records[last]
        it0 = r0["iterations"][0]
        itj = rj["iterations"][-1]
        fs = flux_scale
        rg = it0["rates"]
        return dict(
            start=_fields(r0["state_in"], START_FIELDS),
            sources={start: (r0["srcpos"], r0["nflux"]),
                     last: (rj["srcpos"], rj["nflux"])},
            rates_first=dict(
                **{c: getattr(rg, c) for c in RATE_CHANNELS},
                photon_loss=float(rg.photon_loss) * fs,
                lls_loss=float(rg.lls_loss) * fs),
            chem_first=_fields(it0["post"], CHEM_FIELDS),
            slabs_last={s: (v[0], float(v[1]) * fs, float(v[2]) * fs)
                        for s, v in itj["slabs"].items() if s in sample},
            chem_last=dict(**_fields(itj["post"], CHEM_FIELDS),
                           **{"out_" + n: getattr(rj["state_out"], n)
                              for n in OUT_FIELDS}),
            budget=rj["budget"],
        )

    @staticmethod
    def from_control(ctrl, records, start, last, steps, sample, slice_h1):
        """The same outputs computed by `ctrl` (a Reference) from the
        inputs the port was given."""
        r0, rj = records[start], records[last]
        it0 = r0["iterations"][0]
        itj = rj["iterations"][-1]
        s0, sj = steps[start], steps[last]
        init = ctrl.initial_state(s0)
        sp0, nf0 = ctrl.sources(s0, init.h1)
        spj, nfj = ctrl.sources(sj, slice_h1[sj["slice"]])
        pre0 = ctrl.begin(init)
        rates0 = ctrl.sweep(pre0, sp0, nf0, it0["radius"], s0)
        post0 = ctrl.chemistry(pre0, rates0, s0)
        slabs = {}
        for i, slab, pl, ll in ctrl.source_slabs(
                itj["pre"], spj[sample], nfj[sample], itj["radius"], sj):
            slabs[sample[i]] = (slab, pl, ll)
        postj = ctrl.chemistry(itj["pre"], itj["rates"], sj)
        weights = {"first": absorbers(pre0), "last": absorbers(itj["pre"])}
        outj = ctrl.finish(postj)
        budget = ctrl.budget(rj["state_in"], rj["state_out"], sj,
                             ctrl.total_source_rate(nfj) * sj["dt"], 0.0, 0.0)
        return dict(
            start=_fields(init, START_FIELDS),
            sources={start: (sp0, nf0), last: (spj, nfj)},
            rates_first=dict(**{c: getattr(rates0, c)
                                for c in RATE_CHANNELS},
                             photon_loss=float(rates0.photon_loss),
                             lls_loss=float(rates0.lls_loss)),
            chem_first=_fields(post0, CHEM_FIELDS),
            slabs_last=slabs,
            chem_last=dict(**_fields(postj, CHEM_FIELDS),
                           **{"out_" + n: getattr(outj, n)
                              for n in OUT_FIELDS}),
            budget=budget,
            weights=weights,
        )


def _rate_errors(got: dict, want: dict, weights: dict, detail, tag):
    """The channels of a rate grid: the photo-ionization channels as
    ionizations per unit volume (the rate per atom times `weights`),
    each against the norm of all of them together, since a channel of
    an absent species carries none; the heating and the losses each on
    its own scale."""
    dev = weights["phih"].device
    vol = {}
    for ch in weights:
        vol[ch] = tuple(torch.as_tensor(x[ch]).double().to(dev).reshape(-1)
                        * weights[ch] for x in (got, want))
    total = sum(w for _, w in vol.values())
    scale = float(torch.linalg.vector_norm(total))
    worst = 0.0
    for ch, (a, b) in vol.items():
        num = float(torch.linalg.vector_norm(
            _diff(a, b, float(total.abs().max()))))
        v = _finite(num / scale) if scale > 0 else (0.0 if num == 0.0
                                                     else math.inf)
        worst = max(worst, v)
        if detail is not None:
            detail[f"{tag}.{ch}"] = v
    rest = [(k, got[k], want[k]) for k in want if k not in weights]
    return max(worst, _worst(rest, detail, tag))


def _not_finite(x) -> int:
    """Values that are not numbers, over every output judged."""
    if isinstance(x, dict):
        return sum(_not_finite(v) for v in x.values())
    if isinstance(x, (tuple, list)):
        return sum(_not_finite(v) for v in x)
    if torch.is_tensor(x):
        return (int((~torch.isfinite(x)).sum()) if x.is_floating_point()
                else 0)
    if isinstance(x, float):
        return 0 if math.isfinite(x) else 1
    return 0


def numbers(judged: dict, want: dict, detail=None) -> dict:
    """The compared numbers: each judged output against the reference's
    (`want`, from `Judged.from_control` with the float64 reference).
    `detail`, a dict, receives each field's and channel's reading."""
    out = {"not_finite": float(_not_finite(judged))}
    d = detail
    out["start"] = _worst(((n, judged["start"][n], want["start"][n])
                           for n in START_FIELDS), d, "start")
    worst = 0.0
    for step, (sp, nf) in judged["sources"].items():
        wsp, wnf = want["sources"][step]
        if tuple(sp.shape) != tuple(wsp.shape) or not torch.equal(
                sp.long().cpu(), wsp.long().cpu()):
            worst = math.inf
            break
        worst = max(worst, rel(nf, wnf))
    out["sources"] = worst
    out["rates_first"] = _rate_errors(judged["rates_first"],
                                      want["rates_first"],
                                      want["weights"]["first"], d,
                                      "rates_first")
    out["chem_first"] = _worst(((n, judged["chem_first"][n],
                                 want["chem_first"][n]) for n in CHEM_FIELDS),
                               d, "chem_first")
    js, ws = judged["slabs_last"], want["slabs_last"]
    if set(js) != set(ws) or not ws:
        out["slabs_last"] = math.inf
    else:
        worst = 0.0
        for s in ws:
            got, want_s = ({ch: x[s][0][:, c] for c, ch in
                            enumerate(RATE_CHANNELS)} for x in (js, ws))
            got.update(photon_loss=js[s][1], lls_loss=js[s][2])
            want_s.update(photon_loss=ws[s][1], lls_loss=ws[s][2])
            worst = max(worst, _rate_errors(got, want_s,
                                            want["weights"]["last"], d,
                                            f"slabs_last.{s}"))
        out["slabs_last"] = worst
    out["chem_last"] = _worst(((n, judged["chem_last"][n],
                                want["chem_last"][n])
                               for n in want["chem_last"]), d, "chem_last")
    jb, wb = judged["budget"], want["budget"]
    src = max(abs(float(wb.total_src)), 1e-300)
    terms = {t: abs(float(getattr(jb, t)) - float(getattr(wb, t))) / src
             for t in BUDGET_TERMS}
    terms["photon_conservation"] = abs(float(jb.photon_conservation)
                                       - float(wb.photon_conservation))
    terms = {k: _finite(v) for k, v in terms.items()}
    if d is not None:
        d.update({f"budget.{k}": v for k, v in terms.items()})
    out["budget"] = max(terms.values())
    return out
