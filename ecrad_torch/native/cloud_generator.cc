// Native (C++/OpenMP) bit-exact McICA stochastic cloud generator.
//
// Reference behavior: utilities/radiation_random_numbers_mix.F90
// (lagged-Fibonacci RNG, p=273 q=607), radiation/radiation_cloud_cover.F90
// (Max-Ran / Exp-Ran / Exp-Exp cumulators), radiation_pdf_sampler.F90
// (bilinear LUT sample), radiation_cloud_generator.F90 (per-column
// generation in exact draw order).
//
// This is the host-side runtime component of the driver: the reference
// parallelizes columns with OpenMP (driver/ecrad_driver.F90:339-384) and
// so do we.  Results are bit-identical to the numpy form in
// ecrad_torch/solvers/cloud_generator_exact.py, and to the JAX package's
// copy of this source (tests/test_torch_cloud_generator_exact.py).
//
// Build: ecrad_torch/native/__init__.py compiles this with
//   g++ -O2 -fPIC -shared -fopenmp
// into build/ecrad_torch/ at first use and binds it with ctypes.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

namespace {

constexpr int JPP = 273;
constexpr int JPQ = 607;
constexpr int JPS = 105;
constexpr int JPMM = 30;
constexpr uint32_t MASK30 = (1u << JPMM) - 1u;
constexpr uint32_t JPMASK = 123459876u;
const double MAX_CLOUD_FRAC = 1.0 - 2.220446049250313e-16 * 10.0;
const double MIN_FRAC = 1.0e-6;

// ---------------------------------------------------------------------
struct RandomStream {
  uint32_t ix[JPQ + 1];  // 1-based as in the Fortran
  int iused;
  double zrm;

  explicit RandomStream(int64_t seed) {
    int32_t idum32 =
        (int32_t)((uint32_t)(seed & 0xFFFFFFFFll) ^ JPMASK);
    int64_t idum = std::llabs((int64_t)idum32);
    if (idum == 0) idum = JPMASK;

    uint32_t v = (uint32_t)(idum & 0xFFFFFFFFll);
    auto shift_step = [](uint32_t x) -> uint32_t {
      if (x & 0x80000000u) return ((x ^ 87u) << 1) | 1u;
      return (x << 1) & 0xFFFFFFFEu;
    };
    for (int i = 0; i < 64; ++i) v = shift_step(v);

    std::memset(ix, 0, sizeof(ix));
    ix[2] = (v & ((1u << (JPMM - 1)) - 1u)) << 1;
    ix[JPQ] = (v >> (JPMM - 1)) & ((1u << (32 + 1 - JPMM)) - 1u);
    for (int jbit = 1; jbit < JPMM; ++jbit) {
      for (int jj = 3; jj < JPQ; ++jj) {
        if (v & 0x80000000u) {
          v = shift_step(v);
          ix[jj] |= (1u << jbit);
        } else {
          v = shift_step(v);
        }
      }
    }
    ix[JPQ - JPS] |= 1u;
    iused = JPQ;
    zrm = 1.0 / (double)(1u << JPMM);
    // warmup: discard 999 draws
    double tmp[999];
    uniform(tmp, 999);
  }

  void uniform(double* out, int n) {
    int filled = 0;
    int take = std::min(JPQ, n + iused) - iused;
    if (take > 0) {
      for (int i = 0; i < take; ++i)
        out[i] = ix[iused + 1 + i] * zrm;
      iused += take;
      filled = take;
    }
    while (filled < n) {
      for (int jj = 1; jj <= JPP; ++jj)
        ix[jj] = (ix[jj] + ix[jj - JPP + JPQ]) & MASK30;
      for (int jj = JPP + 1; jj <= JPQ; ++jj)
        ix[jj] = (ix[jj] + ix[jj - JPP]) & MASK30;
      iused = std::min(JPQ, n - filled);
      for (int i = 0; i < iused; ++i)
        out[filled + i] = ix[1 + i] * zrm;
      filled += iused;
    }
  }
};

// ---------------------------------------------------------------------
struct PdfSampler {
  const double* val;  // (ncdf, nfsd) row-major
  int ncdf, nfsd;
  double fsd1, inv_fsd_interval;

  double sample(double fsd, double cdf) const {
    double wcdf = cdf * (ncdf - 1) + 1.0;
    int icdf = (int)wcdf;
    icdf = std::max(1, std::min(icdf, ncdf - 1));
    wcdf = std::max(0.0, std::min(wcdf - icdf, 1.0));
    double wfsd = (fsd - fsd1) * inv_fsd_interval + 1.0;
    int ifsd = (int)wfsd;
    ifsd = std::max(1, std::min(ifsd, nfsd - 1));
    wfsd = std::max(0.0, std::min(wfsd - ifsd, 1.0));
    const double* v = val;
    return (1 - wcdf) * (1 - wfsd) * v[(icdf - 1) * nfsd + ifsd - 1] +
           (1 - wcdf) * wfsd * v[(icdf - 1) * nfsd + ifsd] +
           wcdf * (1 - wfsd) * v[icdf * nfsd + ifsd - 1] +
           wcdf * wfsd * v[icdf * nfsd + ifsd];
  }
};

// ---------------------------------------------------------------------
double beta2alpha(double beta, double f1, double f2) {
  if (beta < 1.0) {
    double fd = std::fabs(f1 - f2);
    return beta + (1.0 - beta) * fd / (fd + 1.0 / beta - 1.0);
  }
  return 1.0;
}

void cum_exp_ran(int nlev, const double* frac, const double* op,
                 bool is_beta, double* cum, double* pair) {
  double cum_product = 1.0 - frac[0];
  cum[0] = frac[0];
  for (int j = 0; j < nlev - 1; ++j) {
    double alpha = is_beta ? beta2alpha(op[j], frac[j], frac[j + 1])
                           : op[j];
    pair[j] = alpha * std::max(frac[j], frac[j + 1]) +
              (1.0 - alpha) *
                  (frac[j] + frac[j + 1] - frac[j] * frac[j + 1]);
    if (frac[j] >= MAX_CLOUD_FRAC)
      cum_product = 0.0;
    else
      cum_product = cum_product * (1.0 - pair[j]) / (1.0 - frac[j]);
    cum[j + 1] = 1.0 - cum_product;
  }
}

void cum_max_ran(int nlev, const double* frac, double* cum,
                 double* pair) {
  double cum_product = 1.0 - frac[0];
  cum[0] = frac[0];
  for (int j = 0; j < nlev - 1; ++j) {
    pair[j] = std::max(frac[j], frac[j + 1]);
    if (frac[j] >= MAX_CLOUD_FRAC)
      cum_product = 0.0;
    else
      cum_product = cum_product * (1.0 - pair[j]) / (1.0 - frac[j]);
    cum[j + 1] = 1.0 - cum_product;
  }
}

void cum_exp_exp(int nlev, const double* frac, const double* op,
                 bool is_beta, double* cum, double* pair) {
  std::fill(cum, cum + nlev, 0.0);
  std::fill(pair, pair + nlev - 1, 0.0);
  std::vector<int> i_top, i_max, i_base;
  int jlev = 0;
  while (jlev < nlev) {
    if (frac[jlev] > MIN_FRAC) {
      i_top.push_back(jlev);
      ++jlev;
      while (jlev < nlev && frac[jlev] >= frac[jlev - 1]) ++jlev;
      i_max.push_back(jlev - 1);
      while (jlev < nlev && frac[jlev] <= frac[jlev - 1] &&
             frac[jlev] > MIN_FRAC)
        ++jlev;
      i_base.push_back(jlev - 1);
    } else {
      ++jlev;
    }
  }
  int nobj = (int)i_top.size();
  if (nobj == 0) return;

  std::vector<double> alpha_lev(nlev - 1);
  for (int j = 0; j < nlev - 1; ++j)
    alpha_lev[j] = is_beta ? beta2alpha(op[j], frac[j], frac[j + 1])
                           : op[j];
  for (int j = 0; j < nlev - 1; ++j)
    pair[j] = alpha_lev[j] * std::max(frac[j], frac[j + 1]) +
              (1.0 - alpha_lev[j]) *
                  (frac[j] + frac[j + 1] - frac[j] * frac[j + 1]);
  std::vector<double> alpha_obj(nobj, 0.0);
  for (int jobj = 0; jobj < nobj - 1; ++jobj) {
    double p = 1.0;
    for (int j = i_max[jobj]; j < i_max[jobj + 1]; ++j)
      p *= alpha_lev[j];
    alpha_obj[jobj] = p;
  }
  std::vector<double> cc_obj(nobj);
  for (int jobj = 0; jobj < nobj; ++jobj) {
    cum[i_top[jobj]] = frac[i_top[jobj]];
    for (int j = i_top[jobj]; j < i_base[jobj]; ++j) {
      if (frac[j] >= MAX_CLOUD_FRAC)
        cum[j + 1] = 1.0;
      else
        cum[j + 1] =
            1.0 - (1.0 - cum[j]) * (1.0 - pair[j]) / (1.0 - frac[j]);
    }
    cc_obj[jobj] = cum[i_base[jobj]];
  }
  // linked-list object merge (radiation_cloud_cover.F90:567-607)
  std::vector<int> i_next(nobj);
  for (int i = 0; i < nobj; ++i) i_next[i] = i + 1;
  std::vector<int> i_base_l(i_base);
  std::vector<double> alpha_l(alpha_obj), cc_l(cc_obj);
  int n = nobj;
  int iobj1 = 0;
  while (n > 1) {
    double alpha_max = 0.0;
    iobj1 = 0;
    int jobj = 0;
    while (jobj + 1 < n) {
      if (alpha_l[jobj] > alpha_max) {
        alpha_max = alpha_l[jobj];
        iobj1 = jobj;
      }
      jobj = i_next[jobj];
    }
    int iobj2 = i_next[iobj1];
    for (int j = i_base_l[iobj1] + 1; j < i_top[iobj2]; ++j)
      cum[j] = cum[i_base_l[iobj1]];
    double cc_pair =
        alpha_l[iobj1] * std::max(cc_l[iobj1], cc_l[iobj2]) +
        (1.0 - alpha_l[iobj1]) *
            (cc_l[iobj1] + cc_l[iobj2] - cc_l[iobj1] * cc_l[iobj2]);
    double scaling = std::min(
        std::max((cc_pair - cc_l[iobj1]) /
                     std::max(MIN_FRAC, cc_l[iobj2]),
                 0.0),
        1.0);
    for (int j = i_top[iobj2]; j <= i_base_l[iobj2]; ++j)
      cum[j] = cum[i_base_l[iobj1]] + cum[j] * scaling;
    cc_l[iobj1] = cc_pair;
    i_base_l[iobj1] = i_base_l[iobj2];
    i_next[iobj1] = i_next[iobj2];
    alpha_l[iobj1] = alpha_l[iobj2];
    --n;
  }
  for (int j = i_base_l[iobj1] + 1; j < nlev; ++j)
    cum[j] = cum[i_base_l[iobj1]];
  for (int j = 0; j < nlev - 1; ++j)
    pair[j] = std::max(pair[j], frac[j] + cum[j + 1] - cum[j]);
  for (int j = 0; j < nlev; ++j) cum[j] = std::min(cum[j], 1.0);
}

// ---------------------------------------------------------------------
void generate_exp_ran(int jg, int nlev, RandomStream& stream,
                      const PdfSampler& pdf, const double* frac,
                      const double* pair, const double* cum,
                      const double* overhang, const double* fsd,
                      const double* op_inhom, int itrigger, int iend,
                      int ng, double* od_scaling /* (nlev, ng) */) {
  int n_layers_to_scale = 1;
  int iy = -1;
  std::vector<double> rand_cloud(std::max(1, iend + 1 - itrigger));
  stream.uniform(rand_cloud.data(), iend + 1 - itrigger);
  std::vector<double> rand1, rand2;
  for (int jlev = itrigger + 1; jlev <= iend + 1; ++jlev) {
    bool do_fill = false;
    if (jlev <= iend) {
      ++iy;
      if (n_layers_to_scale > 0) {
        if (rand_cloud[iy] * frac[jlev - 1] <
            frac[jlev] + frac[jlev - 1] - pair[jlev - 1])
          ++n_layers_to_scale;
        else
          do_fill = true;
      } else {
        if (rand_cloud[iy] * (cum[jlev - 1] - frac[jlev - 1]) <
            pair[jlev - 1] - overhang[jlev - 1] - frac[jlev - 1])
          n_layers_to_scale = 1;
      }
    } else {
      do_fill = true;
    }
    if (do_fill) {
      int n = n_layers_to_scale;
      rand1.resize(n);
      rand2.resize(n);
      stream.uniform(rand1.data(), n);
      stream.uniform(rand2.data(), n);
      for (int jc = 1; jc < n; ++jc)
        if (rand2[jc] < op_inhom[jlev - n + jc - 1])
          rand1[jc] = rand1[jc - 1];
      for (int i = 0; i < n; ++i) {
        int lev = jlev - n + i;
        od_scaling[lev * ng + jg] = pdf.sample(fsd[lev], rand1[i]);
      }
      n_layers_to_scale = 0;
    }
  }
}

void generate_exp_exp(int jg, int nlev, RandomStream& stream,
                      const PdfSampler& pdf, const double* frac,
                      const double* pair, const double* cum,
                      const double* overhang, const double* fsd,
                      const double* op_inhom, int itrigger, int iend,
                      int ng, double* od_scaling) {
  std::vector<char> is_cloudy(nlev, 0);
  is_cloudy[itrigger] = 1;
  std::vector<double> rand_cloud(std::max(1, iend + 1 - itrigger));
  stream.uniform(rand_cloud.data(), iend + 1 - itrigger);
  int iy = -1;
  for (int jlev = itrigger + 1; jlev <= iend; ++jlev) {
    ++iy;
    if (is_cloudy[jlev - 1]) {
      if (rand_cloud[iy] * frac[jlev - 1] <
          frac[jlev] + frac[jlev - 1] - pair[jlev - 1])
        is_cloudy[jlev] = 1;
    } else {
      if (rand_cloud[iy] * (cum[jlev - 1] - frac[jlev - 1]) <
          pair[jlev - 1] - overhang[jlev - 1] - frac[jlev - 1])
        is_cloudy[jlev] = 1;
    }
  }
  int n = iend + 1 - itrigger;
  std::vector<double> rand1(n), rand2(n);
  stream.uniform(rand1.data(), n);
  stream.uniform(rand2.data(), n);
  for (int jc = 1; jc < n; ++jc)
    if (rand2[jc] < op_inhom[iend - n + jc]) rand1[jc] = rand1[jc - 1];
  for (int i = 0; i < n; ++i) {
    int lev = itrigger + i;
    od_scaling[lev * ng + jg] =
        is_cloudy[lev] ? pdf.sample(fsd[lev], rand1[i]) : 0.0;
  }
}

}  // namespace

extern "C" {

// od_scaling: (ncol, nlev, ng) row-major, zero-initialized by caller or
// here; total_cloud_cover: (ncol,).
void ecrad_cloud_generator(
    int ncol, int nlev, int ng, int i_overlap_scheme,
    const int64_t* iseed, double frac_threshold, const double* frac,
    const double* overlap_param, double decorrelation_scaling,
    const double* fractional_std, const double* pdf_val, int ncdf,
    int nfsd, double fsd1, double inv_fsd_interval,
    int use_beta_overlap, double* od_scaling,
    double* total_cloud_cover) {
  PdfSampler pdf{pdf_val, ncdf, nfsd, fsd1, inv_fsd_interval};
#pragma omp parallel for schedule(dynamic)
  for (int jcol = 0; jcol < ncol; ++jcol) {
    const double* f = frac + (size_t)jcol * nlev;
    const double* op = overlap_param + (size_t)jcol * (nlev - 1);
    const double* fsd = fractional_std + (size_t)jcol * nlev;
    double* od = od_scaling + (size_t)jcol * nlev * ng;
    std::memset(od, 0, sizeof(double) * nlev * ng);

    std::vector<double> cum(nlev), pair(nlev - 1);
    if (i_overlap_scheme == 1)
      cum_exp_ran(nlev, f, op, use_beta_overlap, cum.data(),
                  pair.data());
    else if (i_overlap_scheme == 0)
      cum_max_ran(nlev, f, cum.data(), pair.data());
    else
      cum_exp_exp(nlev, f, op, use_beta_overlap, cum.data(),
                  pair.data());

    double tcc = cum[nlev - 1];
    if (tcc < frac_threshold) {
      total_cloud_cover[jcol] = 0.0;
      continue;
    }
    total_cloud_cover[jcol] = tcc;

    int ibegin = 0;
    while (ibegin < nlev && !(f[ibegin] > 0.0)) ++ibegin;
    int iend = nlev - 1;
    while (iend >= 0 && !(f[iend] > 0.0)) --iend;

    std::vector<double> overhang(nlev - 1);
    for (int j = 0; j < nlev - 1; ++j)
      overhang[j] = cum[j + 1] - cum[j];
    std::vector<double> op_inhom(op, op + nlev - 1);
    for (int j = ibegin; j < iend; ++j)
      if (op[j] > 0.0)
        op_inhom[j] = std::pow(op[j], 1.0 / decorrelation_scaling);

    RandomStream stream(iseed[jcol]);
    std::vector<double> rand_top(ng);
    stream.uniform(rand_top.data(), ng);

    for (int jg = 0; jg < ng; ++jg) {
      double trigger = rand_top[jg] * tcc;
      int jlev = ibegin;
      while (trigger > cum[jlev] && jlev < iend) ++jlev;
      int itrigger = jlev;
      if (i_overlap_scheme != 2)
        generate_exp_ran(jg, nlev, stream, pdf, f, pair.data(),
                         cum.data(), overhang.data(), fsd,
                         op_inhom.data(), itrigger, iend, ng, od);
      else
        generate_exp_exp(jg, nlev, stream, pdf, f, pair.data(),
                         cum.data(), overhang.data(), fsd,
                         op_inhom.data(), itrigger, iend, ng, od);
    }
  }
}

}  // extern "C"
