"""Bit-exact host-side McICA cloud generator (port of
``ecrad_tpu/solvers/cloud_generator_exact.py``).

Numpy reimplementation of the reference's serial stochastic cloud
generator, so that McICA runs reproduce the reference's sample:
  * lagged-Fibonacci RNG (p,q)=(273,607)
    (utilities/radiation_random_numbers_mix.F90:12-110)
  * overlap cumulators (radiation/radiation_cloud_cover.F90:169-623)
  * PDF sampling LUT (radiation/radiation_pdf_sampler.F90:59-105)
  * per-column generator (radiation/radiation_cloud_generator.F90:37-520)

``cloud_generator_all_columns`` runs the native C++/OpenMP form
(``ecrad_torch/native``) unless the caller asks for this numpy form with
``allow_native=False``; both give the same bits.  The offline driver's
default sample comes from here; the device generator
(``solvers/cloud_generator.py``) draws a counter-based sample with the
same statistics.  Both produce the ``od_scaling`` and
``total_cloud_cover`` that the McICA solvers take.
"""

from __future__ import annotations

import numpy as np

JPP, JPQ, JPS = 273, 607, 105
JPMM = 30
JPM = 2 ** JPMM
_MASK30 = JPM - 1         # IAND with Z"3FFFFFFF"
_JPMASK = 123459876
MAX_CLOUD_FRAC = 1.0 - np.finfo(np.float64).eps * 10.0
MIN_FRAC = 1.0e-6


class RandomStreamMix:
    """utilities/radiation_random_numbers_mix.F90 RANDOMNUMBERSTREAM."""

    def __init__(self, seed: int):
        # Fortran ABS(IEOR(..)) on signed 32-bit:
        idum32 = np.int32(np.uint32(int(seed) & 0xFFFFFFFF)
                          ^ np.uint32(_JPMASK))
        idum = int(abs(int(idum32)))
        if idum == 0:
            idum = _JPMASK

        def shift_step(v):
            if v & 0x80000000:
                return (((v ^ 87) << 1) | 1) & 0xFFFFFFFF
            return (v << 1) & 0xFFFFFFFE & 0xFFFFFFFF

        v = idum & 0xFFFFFFFF
        for _ in range(64):
            v = shift_step(v)

        ix = np.zeros(JPQ + 1, dtype=np.int64)   # 1-based
        ix[2] = (v & ((1 << (JPMM - 1)) - 1)) << 1
        ix[JPQ] = (v >> (JPMM - 1)) & ((1 << (32 + 1 - JPMM)) - 1)
        for jbit in range(1, JPMM):
            for jj in range(3, JPQ):
                if v & 0x80000000:
                    v = shift_step(v)
                    ix[jj] |= (1 << jbit)
                else:
                    v = shift_step(v)
        ix[JPQ - JPS] |= 1
        self.ix = ix
        self.iused = JPQ
        self.zrm = 1.0 / JPM
        # warmup: 999 draws discarded
        self.uniform(999)

    def uniform(self, n: int) -> np.ndarray:
        out = np.empty(n)
        filled = 0
        # serve leftovers
        take = min(JPQ, n + self.iused) - self.iused
        if take > 0:
            out[:take] = self.ix[self.iused + 1:self.iused + take + 1] \
                * self.zrm
            self.iused += take
            filled = take
        while filled < n:
            ix = self.ix
            for jj in range(1, JPP + 1):
                ix[jj] = (ix[jj] + ix[jj - JPP + JPQ]) & _MASK30
            for jj in range(JPP + 1, JPQ + 1):
                ix[jj] = (ix[jj] + ix[jj - JPP]) & _MASK30
            self.iused = min(JPQ, n - filled)
            out[filled:filled + self.iused] = \
                ix[1:self.iused + 1] * self.zrm
            filled += self.iused
        return out


# ---------------------------------------------------------------------------

def beta2alpha(beta, frac1, frac2):
    """radiation_cloud_cover.F90:51-66."""
    if beta < 1.0:
        fd = abs(frac1 - frac2)
        return beta + (1.0 - beta) * fd / (fd + 1.0 / beta - 1.0)
    return 1.0


def cum_cloud_cover_exp_ran(frac, overlap_param, is_beta=False):
    """radiation_cloud_cover.F90:169-229 (single column)."""
    nlev = frac.size
    cum = np.zeros(nlev)
    pair = np.zeros(nlev - 1)
    cum_product = 1.0 - frac[0]
    cum[0] = frac[0]
    for jlev in range(nlev - 1):
        alpha = beta2alpha(overlap_param[jlev], frac[jlev],
                           frac[jlev + 1]) if is_beta \
            else overlap_param[jlev]
        pair[jlev] = (alpha * max(frac[jlev], frac[jlev + 1])
                      + (1.0 - alpha) * (frac[jlev] + frac[jlev + 1]
                                         - frac[jlev] * frac[jlev + 1]))
        if frac[jlev] >= MAX_CLOUD_FRAC:
            cum_product = 0.0
        else:
            cum_product = cum_product * (1.0 - pair[jlev]) \
                / (1.0 - frac[jlev])
        cum[jlev + 1] = 1.0 - cum_product
    return cum, pair


def cum_cloud_cover_max_ran(frac):
    """radiation_cloud_cover.F90:124-167 (single column)."""
    nlev = frac.size
    cum = np.zeros(nlev)
    pair = np.zeros(nlev - 1)
    cum_product = 1.0 - frac[0]
    cum[0] = frac[0]
    for jlev in range(nlev - 1):
        pair[jlev] = max(frac[jlev], frac[jlev + 1])
        if frac[jlev] >= MAX_CLOUD_FRAC:
            cum_product = 0.0
        else:
            cum_product = cum_product * (1.0 - pair[jlev]) \
                / (1.0 - frac[jlev])
        cum[jlev + 1] = 1.0 - cum_product
    return cum, pair


def cum_cloud_cover_exp_exp(frac, overlap_param, is_beta=False):
    """radiation_cloud_cover.F90:339-623 object-based Exp-Exp overlap
    (single column)."""
    nlev = frac.size
    cum = np.zeros(nlev)
    pair = np.zeros(nlev - 1)

    # identify contiguous cloud "objects"
    i_top, i_max, i_base = [], [], []
    jlev = 0
    while jlev < nlev:
        if frac[jlev] > MIN_FRAC:
            i_top.append(jlev)
            jlev += 1
            while jlev < nlev and frac[jlev] >= frac[jlev - 1]:
                jlev += 1
            i_max.append(jlev - 1)
            while jlev < nlev and frac[jlev] <= frac[jlev - 1] \
                    and frac[jlev] > MIN_FRAC:
                jlev += 1
            i_base.append(jlev - 1)
        else:
            jlev += 1
    nobj = len(i_top)
    if nobj == 0:
        return cum, pair

    if is_beta:
        alpha_lev = np.array([beta2alpha(overlap_param[j], frac[j],
                                         frac[j + 1])
                              for j in range(nlev - 1)])
    else:
        alpha_lev = np.asarray(overlap_param, float)
    for j in range(nlev - 1):
        pair[j] = (alpha_lev[j] * max(frac[j], frac[j + 1])
                   + (1.0 - alpha_lev[j])
                   * (frac[j] + frac[j + 1] - frac[j] * frac[j + 1]))
    alpha_obj = np.zeros(nobj)
    for jobj in range(nobj - 1):
        alpha_obj[jobj] = np.prod(alpha_lev[i_max[jobj]:i_max[jobj + 1]])

    cc_obj = np.zeros(nobj)
    for jobj in range(nobj):
        cum[i_top[jobj]] = frac[i_top[jobj]]
        for j in range(i_top[jobj], i_base[jobj]):
            if frac[j] >= MAX_CLOUD_FRAC:
                cum[j + 1] = 1.0
            else:
                cum[j + 1] = 1.0 - (1.0 - cum[j]) * (1.0 - pair[j]) \
                    / (1.0 - frac[j])
        cc_obj[jobj] = cum[i_base[jobj]]

    # Linked-list merge of objects, exactly as the Fortran do-while
    # structure (radiation_cloud_cover.F90:567-607): i_next holds the
    # 0-based index of the next active object; the traversal condition
    # compares the (1-based) node index against the CURRENT object count.
    i_next = list(range(1, nobj + 1))
    i_base_l = list(i_base)
    alpha_l = list(alpha_obj)
    cc_l = list(cc_obj)
    n = nobj
    iobj1 = 0
    while n > 1:
        alpha_max = 0.0
        iobj1 = 0
        jobj = 0
        while jobj + 1 < n:          # Fortran: do while (jobj < nobj)
            if alpha_l[jobj] > alpha_max:
                alpha_max = alpha_l[jobj]
                iobj1 = jobj
            jobj = i_next[jobj]
        iobj2 = i_next[iobj1]
        cum[i_base_l[iobj1] + 1:i_top[iobj2]] = cum[i_base_l[iobj1]]
        cc_pair = (alpha_l[iobj1] * max(cc_l[iobj1], cc_l[iobj2])
                   + (1.0 - alpha_l[iobj1])
                   * (cc_l[iobj1] + cc_l[iobj2]
                      - cc_l[iobj1] * cc_l[iobj2]))
        scaling = min(max((cc_pair - cc_l[iobj1])
                          / max(MIN_FRAC, cc_l[iobj2]), 0.0), 1.0)
        for j in range(i_top[iobj2], i_base_l[iobj2] + 1):
            cum[j] = cum[i_base_l[iobj1]] + cum[j] * scaling
        cc_l[iobj1] = cc_pair
        i_base_l[iobj1] = i_base_l[iobj2]
        i_next[iobj1] = i_next[iobj2]
        alpha_l[iobj1] = alpha_l[iobj2]
        n -= 1
    cum[i_base_l[iobj1] + 1:] = cum[i_base_l[iobj1]]
    for j in range(nlev - 1):
        pair[j] = max(pair[j], frac[j] + cum[j + 1] - cum[j])
    np.minimum(cum, 1.0, out=cum)
    return cum, pair


# ---------------------------------------------------------------------------

class PdfSampler:
    """radiation_pdf_sampler.F90 LUT (from data/mcica_*.nc)."""

    def __init__(self, fsd, val):
        self.val = np.asarray(val)            # (ncdf, nfsd)
        self.ncdf, self.nfsd = self.val.shape
        self.fsd1 = float(fsd[0])
        self.inv_fsd_interval = 1.0 / float(fsd[1] - fsd[0])

    @classmethod
    def from_file(cls, path):
        from ecrad_torch.io.netcdf import NcFile
        with NcFile(path) as f:
            fsd = f.get("fsd")
            val = f.get("x")
        # easy_netcdf reads x(ncdf,nfsd) column-major; scipy gives the
        # C-order transpose, i.e. (nfsd, ncdf) → transpose back
        return cls(fsd, val.T)

    def sample(self, fsd, cdf):
        """Elemental bilinear lookup
        (radiation_pdf_sampler.F90:59-105)."""
        fsd = np.asarray(fsd, float)
        cdf = np.asarray(cdf, float)
        wcdf = cdf * (self.ncdf - 1) + 1.0
        icdf = np.clip(wcdf.astype(int), 1, self.ncdf - 1)
        wcdf = np.clip(wcdf - icdf, 0.0, 1.0)
        wfsd = (fsd - self.fsd1) * self.inv_fsd_interval + 1.0
        ifsd = np.clip(wfsd.astype(int), 1, self.nfsd - 1)
        wfsd = np.clip(wfsd - ifsd, 0.0, 1.0)
        v = self.val
        return ((1 - wcdf) * (1 - wfsd) * v[icdf - 1, ifsd - 1]
                + (1 - wcdf) * wfsd * v[icdf - 1, ifsd]
                + wcdf * (1 - wfsd) * v[icdf, ifsd - 1]
                + wcdf * wfsd * v[icdf, ifsd])


# ---------------------------------------------------------------------------

OVERLAP_MAX_RAN = 0
OVERLAP_EXP_RAN = 1
OVERLAP_EXP_EXP = 2


def cloud_generator_column(ng, nlev, i_overlap_scheme, iseed,
                           frac_threshold, frac, overlap_param,
                           decorrelation_scaling, fractional_std,
                           pdf_sampler: PdfSampler,
                           use_beta_overlap=False):
    """radiation_cloud_generator.F90:37-160 for one column.

    Returns (od_scaling (ng, nlev), total_cloud_cover)."""
    frac = np.asarray(frac, float)
    overlap_param = np.asarray(overlap_param, float)
    fractional_std = np.asarray(fractional_std, float)

    if i_overlap_scheme == OVERLAP_EXP_RAN:
        cum, pair = cum_cloud_cover_exp_ran(frac, overlap_param,
                                            use_beta_overlap)
    elif i_overlap_scheme == OVERLAP_MAX_RAN:
        cum, pair = cum_cloud_cover_max_ran(frac)
    elif i_overlap_scheme == OVERLAP_EXP_EXP:
        cum, pair = cum_cloud_cover_exp_exp(frac, overlap_param,
                                            use_beta_overlap)
    else:
        raise ValueError("unknown overlap scheme")

    total_cloud_cover = cum[nlev - 1]
    overhang = cum[1:] - cum[:-1]
    od_scaling = np.zeros((ng, nlev))

    if total_cloud_cover < frac_threshold:
        return od_scaling, 0.0

    # first/last cloudy layers (0-based)
    ibegin = int(np.argmax(frac > 0.0))
    iend = int(nlev - 1 - np.argmax(frac[::-1] > 0.0))

    overlap_param_inhom = overlap_param.copy()
    sel = slice(ibegin, iend)
    pos = overlap_param[sel] > 0.0
    overlap_param_inhom[sel] = np.where(
        pos, overlap_param[sel] ** (1.0 / decorrelation_scaling),
        overlap_param[sel])

    stream = RandomStreamMix(iseed)
    rand_top = stream.uniform(ng)

    for jg in range(ng):
        trigger = rand_top[jg] * total_cloud_cover
        jlev = ibegin
        while trigger > cum[jlev] and jlev < iend:
            jlev += 1
        itrigger = jlev       # 0-based

        if i_overlap_scheme != OVERLAP_EXP_EXP:
            _generate_column_exp_ran(
                ng, nlev, jg, stream, pdf_sampler, frac, pair, cum,
                overhang, fractional_std, overlap_param_inhom, itrigger,
                iend, od_scaling)
        else:
            _generate_column_exp_exp(
                ng, nlev, jg, stream, pdf_sampler, frac, pair, cum,
                overhang, fractional_std, overlap_param_inhom, itrigger,
                iend, od_scaling)

    return od_scaling, total_cloud_cover


def _generate_column_exp_ran(ng, nlev, jg, stream, pdf_sampler, frac,
                             pair, cum, overhang, fractional_std,
                             overlap_param_inhom, itrigger, iend,
                             od_scaling):
    """radiation_cloud_generator.F90:262-352 (0-based indices)."""
    n_layers_to_scale = 1
    iy = -1
    rand_cloud = stream.uniform(iend + 1 - itrigger)
    for jlev in range(itrigger + 1, iend + 2):
        do_fill = False
        if jlev <= iend:
            iy += 1
            if n_layers_to_scale > 0:
                if rand_cloud[iy] * frac[jlev - 1] < \
                        frac[jlev] + frac[jlev - 1] - pair[jlev - 1]:
                    n_layers_to_scale += 1
                else:
                    do_fill = True
            else:
                if rand_cloud[iy] * (cum[jlev - 1] - frac[jlev - 1]) < \
                        pair[jlev - 1] - overhang[jlev - 1] \
                        - frac[jlev - 1]:
                    n_layers_to_scale = 1
        else:
            do_fill = True
        if do_fill:
            n = n_layers_to_scale
            rand1 = stream.uniform(n)
            rand2 = stream.uniform(n)
            for jc in range(1, n):
                if rand2[jc] < overlap_param_inhom[jlev - n + jc - 1]:
                    rand1[jc] = rand1[jc - 1]
            sl = slice(jlev - n, jlev)
            od_scaling[jg, sl] = pdf_sampler.sample(fractional_std[sl],
                                                    rand1)
            n_layers_to_scale = 0


def _generate_column_exp_exp(ng, nlev, jg, stream, pdf_sampler, frac,
                             pair, cum, overhang, fractional_std,
                             overlap_param_inhom, itrigger, iend,
                             od_scaling):
    """radiation_cloud_generator.F90:396-520 (0-based indices)."""
    is_cloudy = np.zeros(nlev, bool)
    is_cloudy[itrigger] = True
    rand_cloud = stream.uniform(iend + 1 - itrigger)
    iy = -1
    for jlev in range(itrigger + 1, iend + 1):
        iy += 1
        if is_cloudy[jlev - 1]:
            if rand_cloud[iy] * frac[jlev - 1] < \
                    frac[jlev] + frac[jlev - 1] - pair[jlev - 1]:
                is_cloudy[jlev] = True
        else:
            if rand_cloud[iy] * (cum[jlev - 1] - frac[jlev - 1]) < \
                    pair[jlev - 1] - overhang[jlev - 1] - frac[jlev - 1]:
                is_cloudy[jlev] = True
    n = iend + 1 - itrigger
    rand1 = stream.uniform(n)
    rand2 = stream.uniform(n)
    for jc in range(1, n):
        if rand2[jc] < overlap_param_inhom[iend - n + jc]:
            rand1[jc] = rand1[jc - 1]
    sl = slice(itrigger, iend + 1)
    vals = pdf_sampler.sample(fractional_std[sl], rand1)
    od_scaling[jg, sl] = np.where(is_cloudy[sl], vals, 0.0)


def cloud_generator_all_columns(ng, i_overlap_scheme, iseed,
                                frac_threshold, frac, overlap_param,
                                decorrelation_scaling, fractional_std,
                                pdf_sampler, use_beta_overlap=False,
                                allow_native=True):
    """All columns: frac (ncol, nlev), overlap_param (ncol, nlev-1),
    iseed (ncol,). Returns (od_scaling (ncol, nlev, ng), cover (ncol,)).

    Runs the native C++/OpenMP form (ecrad_torch/native, built at first
    use; a failed build raises), or this numpy form when allow_native is
    False.  The two give the same bits."""
    if allow_native:
        from ecrad_torch import native
        return native.cloud_generator_all_columns(
            ng=ng, i_overlap_scheme=i_overlap_scheme, iseed=iseed,
            frac_threshold=frac_threshold, frac=frac,
            overlap_param=overlap_param,
            decorrelation_scaling=decorrelation_scaling,
            fractional_std=fractional_std, pdf_sampler=pdf_sampler,
            use_beta_overlap=use_beta_overlap)
    ncol, nlev = frac.shape
    od_scaling = np.zeros((ncol, nlev, ng))
    cover = np.zeros(ncol)
    for jcol in range(ncol):
        od_s, tcc = cloud_generator_column(
            ng, nlev, i_overlap_scheme, int(iseed[jcol]), frac_threshold,
            frac[jcol], overlap_param[jcol], decorrelation_scaling,
            fractional_std[jcol], pdf_sampler, use_beta_overlap)
        od_scaling[jcol] = od_s.T
        cover[jcol] = tcc
    return od_scaling, cover
