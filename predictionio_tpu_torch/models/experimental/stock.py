"""Stock prediction example with backtesting: the counterpart of
``predictionio_tpu/models/experimental/stock.py``.

Reference mapping (examples/experimental/scala-stock/):

- ``RawData``/``DataView``/``TrainingData`` (Data.scala:24-96) — a
  [time, ticker] price panel with an active mask and a sliding window
  view, a dense numpy [T, N] array; the synthetic generator stands in for
  YahooDataSource.scala (no network).
- Indicators (Indicators.scala): ``RSIIndicator`` (:59-100) and
  ``ShiftsIndicator`` (:109-124), host numpy over [T, N] at once.
- ``RegressionStrategy`` (RegressionStrategy.scala:27-139): regress the
  1-day-forward return on the indicator values per ticker. Every ticker's
  [obs, F+1] least-squares system is solved in ONE launch of the batched
  least-squares kernels on the device (``ops/lstsq.py``, K21; ``train``
  takes the ``torch.device``); the reference solves one ticker at a time.
- ``MomentumStrategy`` (Run.scala:13-45): long-minus-short log-return
  signal, no trained model.
- ``BacktestingEvaluator`` (BackTestingMetrics.scala:36-209): walk
  forward day by day, enter tickers whose predicted return crosses
  ``enter_threshold`` and exit below ``exit_threshold``, simulate a
  max-``max_positions`` equal-cash portfolio, and report daily NAV plus
  annualized return/vol/Sharpe (:139-180). Host numpy.

The engine assembles as DataSource (sliding train/eval windows,
DataSource.scala:21-47) -> strategy algorithm -> first serving, and
``backtest`` runs the reference's Run.scala evaluation loop on the device
of its context (``ctx.device``; no context means CUDA).
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from predictionio_tpu_torch.controller import (
    BaseAlgorithm,
    BaseDataSource,
    EngineFactory,
    Params,
    SimpleEngine,
)
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ops.lstsq import lstsq, require_converged

logger = logging.getLogger(__name__)


# --- data model (reference Data.scala) ---


@dataclasses.dataclass
class RawData:
    """[T, N] price panel (reference RawData, Data.scala:24-50)."""

    tickers: Tuple[str, ...]
    mkt_ticker: str
    time_index: np.ndarray  # [T] int days (epoch-ish ordinals)
    price: np.ndarray  # [T, N] float64
    active: np.ndarray  # [T, N] bool

    def __post_init__(self):
        assert self.price.shape == (len(self.time_index), len(self.tickers))


@dataclasses.dataclass
class DataView:
    """A window of RawData ending at ``idx`` inclusive (Data.scala:58-81)."""

    raw: RawData
    idx: int
    max_window: int

    def _slice(self, arr: np.ndarray, window: int) -> np.ndarray:
        start = self.idx - window + 1
        if start < 0:
            # a negative python slice start would silently wrap to the
            # END of the panel and feed garbage windows into training
            raise ValueError(
                f"window {window} reaches before the panel start "
                f"(idx={self.idx}); shrink the window or raise from_idx"
            )
        return arr[start : self.idx + 1]

    def price_frame(self, window: int = 1) -> np.ndarray:
        """[window, N] prices for [idx - window + 1 : idx]."""
        return self._slice(self.raw.price, window)

    def active_frame(self, window: int = 1) -> np.ndarray:
        return self._slice(self.raw.active, window)

    def today(self) -> int:
        return int(self.raw.time_index[self.idx])


@dataclasses.dataclass
class TrainingData:
    """Visible window [until_idx - max_window, until_idx) (Data.scala:85-91)."""

    until_idx: int
    max_window: int
    raw: RawData

    def view(self) -> DataView:
        return DataView(self.raw, self.until_idx - 1, self.max_window)


@dataclasses.dataclass(frozen=True)
class QueryDate:
    """Reference QueryDate (Data.scala:95)."""

    idx: int = 0


@dataclasses.dataclass
class Query:
    """Reference Query (Data.scala:97-101)."""

    idx: int
    data_view: DataView
    tickers: Tuple[str, ...]
    mkt_ticker: str


@dataclasses.dataclass
class Prediction:
    """ticker -> predicted next-day return (Data.scala:104)."""

    data: Dict[str, float]


# --- synthetic data source (stands in for YahooDataSource.scala) ---


def synthetic_raw_data(
    tickers: Sequence[str] = ("SPY", "AAPL", "MSFT", "GOOG", "AMZN"),
    mkt_ticker: str = "SPY",
    n_days: int = 600,
    seed: int = 7,
) -> RawData:
    """Geometric random-walk panel with per-ticker drift/vol and a market
    factor — enough structure for the momentum/regression strategies to
    have signal on, without network access to a quote API."""
    rng = np.random.default_rng(seed)
    n = len(tickers)
    drift = rng.normal(3e-4, 2e-4, n)
    vol = rng.uniform(0.008, 0.02, n)
    beta = rng.uniform(0.5, 1.5, n)
    mkt = rng.normal(0.0, 0.01, n_days)
    eps = rng.normal(0.0, 1.0, (n_days, n)) * vol
    log_ret = drift + beta * mkt[:, None] + eps
    # a dash of momentum so the strategies beat noise
    log_ret[1:] += 0.15 * log_ret[:-1]
    price = 100.0 * np.exp(np.cumsum(log_ret, axis=0))
    return RawData(
        tickers=tuple(tickers),
        mkt_ticker=mkt_ticker,
        time_index=np.arange(n_days, dtype=np.int64),
        price=price,
        active=np.ones((n_days, n), bool),
    )


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    base_date_idx: int = 300
    from_idx: int = 350
    until_idx: int = 550
    training_window_size: int = 200
    max_test_duration: int = 50
    n_days: int = 600
    seed: int = 7
    # the panel (reference DataSourceParams marketTicker / tickerList)
    mkt_ticker: str = "SPY"
    tickers: Tuple[str, ...] = ("SPY", "AAPL", "MSFT", "GOOG", "AMZN")


class DataSource(BaseDataSource):
    """Sliding train/eval windows (reference DataSource.scala:21-47:
    each eval set trains on [untilIdx - window, untilIdx) and queries
    the following ``maxTestDuration`` days)."""

    params_class = DataSourceParams

    def _raw(self) -> RawData:
        p = self.params
        return synthetic_raw_data(p.tickers, p.mkt_ticker, n_days=p.n_days, seed=p.seed)

    def read_training(self, ctx) -> TrainingData:
        p = self.params
        return TrainingData(p.until_idx, p.training_window_size, self._raw())

    def read_eval(self, ctx):
        p = self.params
        raw = self._raw()
        out = []
        idx = p.from_idx
        while idx < p.until_idx:
            until = min(idx + p.max_test_duration, p.until_idx)
            td = TrainingData(idx, p.training_window_size, raw)
            qa = [
                (
                    Query(
                        j,
                        DataView(raw, j, p.training_window_size),
                        raw.tickers,
                        raw.mkt_ticker,
                    ),
                    None,
                )
                for j in range(idx, until)
            ]
            out.append((td, QueryDate(idx), qa))
            idx = until
        return out


# --- indicators (reference Indicators.scala) ---


class BaseIndicator:
    """[T, N] log-price in, [T, N] indicator out (Indicators.scala:30-52)."""

    def get_training(self, log_price: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def get_one(self, log_price: np.ndarray) -> np.ndarray:
        """Latest value per ticker ([N])."""
        return self.get_training(log_price)[-1]

    def min_window(self) -> int:
        raise NotImplementedError


class ShiftsIndicator(BaseIndicator):
    """period-day log return (Indicators.scala:109-124)."""

    def __init__(self, period: int):
        self.period = period

    def min_window(self) -> int:
        return self.period + 1

    def get_training(self, log_price: np.ndarray) -> np.ndarray:
        out = np.zeros_like(log_price)
        out[self.period :] = log_price[self.period :] - log_price[: -self.period]
        return out


class RSIIndicator(BaseIndicator):
    """Relative Strength Index on daily returns (Indicators.scala:59-100)."""

    def __init__(self, period: int = 14):
        self.period = period

    def min_window(self) -> int:
        return self.period + 1

    def get_training(self, log_price: np.ndarray) -> np.ndarray:
        ret = np.diff(log_price, axis=0, prepend=log_price[:1])
        up = np.where(ret > 0, ret, 0.0)
        down = np.where(ret < 0, -ret, 0.0)
        avg_up = _rolling_mean(up, self.period)
        avg_down = _rolling_mean(down, self.period)
        rs = avg_up / np.maximum(avg_down, 1e-12)
        return 100.0 - 100.0 / (1.0 + rs)


def _rolling_mean(x: np.ndarray, window: int) -> np.ndarray:
    csum = np.cumsum(x, axis=0)
    out = np.empty_like(x)
    out[:window] = csum[:window] / np.arange(1, window + 1)[:, None]
    out[window:] = (csum[window:] - csum[:-window]) / window
    return out


# --- strategies (reference RegressionStrategy.scala / Run.scala) ---


@dataclasses.dataclass(frozen=True)
class RegressionStrategyParams(Params):
    """Reference RegressionStrategyParams (RegressionStrategy.scala:20-23).
    Indicators are fixed (RSI-14 + 1/5/22-day shifts like the example's
    tutorial config) — Params must stay JSON-mappable."""

    max_training_window_size: int = 200
    rsi_period: int = 14
    shifts: Tuple[int, ...] = (1, 5, 22)


class RegressionStrategy(BaseAlgorithm):
    """Per-ticker linear regression of next-day return on indicators,
    solved for ALL tickers in one batched least-squares launch (K21; the
    reference solves one ticker at a time, RegressionStrategy.scala:70-92)."""

    params_class = RegressionStrategyParams
    query_class = QueryDate

    def _indicators(self) -> List[BaseIndicator]:
        return [RSIIndicator(self.params.rsi_period)] + [
            ShiftsIndicator(s) for s in self.params.shifts
        ]

    def design(self, td: TrainingData) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The per-ticker systems of a training window: (X [N, obs, F+1]
        float32 indicators with the intercept column, y [N, obs] float32
        next-day returns, the tickers active on every day [N])."""
        view = td.view()
        price = view.price_frame(td.max_window)  # [W, N]
        active = view.active_frame(td.max_window)
        log_price = np.log(price)
        indicators = self._indicators()
        first = max(ind.min_window() for ind in indicators) + 3
        # next-day return target (reference getRet(logPrice, -1))
        ret_f1 = np.zeros_like(log_price)
        ret_f1[:-1] = log_price[1:] - log_price[:-1]
        feats = np.stack(
            [ind.get_training(log_price) for ind in indicators], axis=-1
        )  # [W, N, F]
        X = feats[first:-1].transpose(1, 0, 2)  # [N, obs, F]
        X = np.concatenate([X, np.ones((*X.shape[:2], 1))], axis=-1)
        y = ret_f1[first:-1].transpose(1, 0)  # [N, obs]
        return (np.ascontiguousarray(X, np.float32), np.ascontiguousarray(y, np.float32),
                active.all(axis=0))

    def train(self, device: torch.device, td: TrainingData) -> Dict[str, np.ndarray]:
        X, y, always_active = self.design(td)
        dev = resolve_device(device)
        coef = require_converged(lstsq(
            torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
        )).x.cpu().numpy()  # [N, F+1]
        # the reference filters out tickers not active on every day
        return {
            t: coef[j]
            for j, t in enumerate(td.raw.tickers)
            if always_active[j]
        }

    def predict(self, model: Dict[str, np.ndarray], query: Query) -> Prediction:
        view = query.data_view
        window = max(ind.min_window() for ind in self._indicators()) + 3
        log_price = np.log(view.price_frame(window))
        lasts = np.stack(
            [ind.get_one(log_price) for ind in self._indicators()], axis=-1
        )  # [N, F]
        out = {}
        for j, t in enumerate(query.tickers):
            coef = model.get(t)
            if coef is None:
                continue
            out[t] = float(lasts[j] @ coef[:-1] + coef[-1])
        return Prediction(data=out)


@dataclasses.dataclass(frozen=True)
class MomentumStrategyParams(Params):
    """Buy when the l-day return runs ahead of the s-day return
    (reference Run.scala:13)."""

    l: int = 20
    s: int = 3


class MomentumStrategy(BaseAlgorithm):
    """Reference MomentumStrategy (Run.scala:15-45): no trained model."""

    params_class = MomentumStrategyParams
    query_class = QueryDate

    def train(self, device: torch.device, td: TrainingData):
        return None  # onClose uses only the query's view

    def predict(self, model, query: Query) -> Prediction:
        p = self.params
        price = query.data_view.price_frame(p.l + 1)
        today = np.log(price[p.l])
        l_ago = np.log(price[0])
        s_ago = np.log(price[p.l - p.s])
        s_ret = (today - s_ago) / p.s
        l_ret = (today - l_ago) / p.l
        sig = l_ret - s_ret
        return Prediction(
            data={t: float(sig[j]) for j, t in enumerate(query.tickers)}
        )


# --- backtesting (reference BackTestingMetrics.scala) ---


@dataclasses.dataclass(frozen=True)
class BacktestingParams(Params):
    """Reference BacktestingParams (:36-41)."""

    enter_threshold: float = 0.001
    exit_threshold: float = 0.0
    max_positions: int = 1


@dataclasses.dataclass
class DailyStat:
    """Reference DailyStat (:57-63)."""

    time: int
    nav: float
    ret: float
    market: float
    position_count: int


@dataclasses.dataclass
class OverallStat:
    """Reference OverallStat (:65-70)."""

    ret: float  # annualized return
    vol: float  # annualized volatility
    sharpe: float
    days: int


@dataclasses.dataclass
class BacktestingResult:
    daily: List[DailyStat]
    overall: OverallStat

    def __str__(self) -> str:
        return str(self.overall)


class BacktestingEvaluator:
    """Walk-forward portfolio simulation (reference BacktestingEvaluator
    evaluateAll, BackTestingMetrics.scala:100-180): update positions by
    today's return, exit/enter per thresholds, book daily NAV, then
    annualize return/vol and report Sharpe."""

    INIT_CASH = 1_000_000.0

    def __init__(self, params: BacktestingParams):
        self.params = params

    def daily_decision(
        self, query_idx: int, prediction: Prediction
    ) -> Tuple[int, List[str], List[str]]:
        """Reference evaluateUnit (:74-97): enter >= enterThreshold,
        exit <= exitThreshold, entries sorted by signal descending."""
        rows = sorted(
            prediction.data.items(), key=lambda kv: -kv[1]
        )
        to_enter = [t for t, v in rows if v >= self.params.enter_threshold]
        to_exit = [t for t, v in rows if v <= self.params.exit_threshold]
        return query_idx, to_enter, to_exit

    def evaluate_all(
        self,
        raw: RawData,
        decisions: Sequence[Tuple[int, List[str], List[str]]],
    ) -> BacktestingResult:
        price = raw.price
        ret = np.ones_like(price)
        ret[1:] = price[1:] / price[:-1]
        col = {t: j for j, t in enumerate(raw.tickers)}
        mkt_col = col[raw.mkt_ticker]
        cash = self.INIT_CASH
        positions: Dict[str, float] = {}
        daily: List[DailyStat] = []
        for idx, to_enter, to_exit in sorted(decisions, key=lambda d: d[0]):
            today_ret = ret[idx]
            for t in positions:
                positions[t] *= today_ret[col[t]]
            for t in to_exit:
                if t in positions:
                    cash += positions.pop(t)
            slack = self.params.max_positions - len(positions)
            if slack > 0 and cash > 0:
                entries = [t for t in to_enter if t not in positions][:slack]
                if entries:
                    money = cash / slack
                    for t in entries:
                        cash -= money
                        positions[t] = money
            nav = cash + sum(positions.values())
            prev_nav = daily[-1].nav if daily else self.INIT_CASH
            daily.append(
                DailyStat(
                    time=int(raw.time_index[idx]),
                    nav=nav,
                    ret=(nav - prev_nav) / prev_nav if daily else 0.0,
                    market=float(price[idx, mkt_col]),
                    position_count=len(positions),
                )
            )
        rets = np.asarray([d.ret for d in daily])
        n = len(daily)
        annual_vol = float(rets.std(ddof=1) * math.sqrt(252.0)) if n > 1 else 0.0
        total = daily[-1].nav / self.INIT_CASH if daily else 1.0
        annual_ret = math.pow(total, 252.0 / max(n, 1)) - 1.0
        sharpe = annual_ret / annual_vol if annual_vol > 0 else 0.0
        return BacktestingResult(
            daily=daily,
            overall=OverallStat(annual_ret, annual_vol, sharpe, n),
        )


def backtest(
    algo: BaseAlgorithm,
    datasource_params: Optional[DataSourceParams] = None,
    backtesting_params: Optional[BacktestingParams] = None,
    ctx=None,
) -> BacktestingResult:
    """The Run.scala loop: per eval window train the strategy on
    ``ctx.device`` (no context: CUDA), decide daily enters/exits from its
    predictions, then simulate the portfolio over the whole period."""
    ds = DataSource(datasource_params or DataSourceParams())
    device = ctx.device if ctx is not None else resolve_device(None)
    ev = BacktestingEvaluator(backtesting_params or BacktestingParams())
    decisions = []
    raw = None
    for td, _, qa in ds.read_eval(ctx):
        raw = td.raw
        model = algo.train(device, td)
        for query, _ in qa:
            pred = algo.predict(model, query)
            decisions.append(ev.daily_decision(query.idx, pred))
    if raw is None:
        raise ValueError("no eval windows — check DataSourceParams")
    return ev.evaluate_all(raw, decisions)


def stock_engine(strategy: str = "regression") -> SimpleEngine:
    """SimpleEngine wiring like the reference Run.scala Workflow config
    (PIdentityPreparator + LFirstServing)."""
    algo = {
        "regression": RegressionStrategy,
        "momentum": MomentumStrategy,
    }[strategy]
    return SimpleEngine(DataSource, algo)


class StockEngineFactory(EngineFactory):
    def apply(self) -> SimpleEngine:
        return stock_engine()
