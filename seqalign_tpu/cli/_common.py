"""Shared CLI machinery mirroring ``alignment_cmdline.c`` (reference C6).

Two-pass argument parsing (case-sensitivity and --scoring presets must be
applied before substitution tables are built, alignment_cmdline.c:196-250),
identical validation rules and error messages, and the exact output helpers
(colour diff, pretty spacer, matrix dump) from alignment.c:353-474.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import sys
from typing import List, Optional, Tuple

# The reference binaries print nothing on startup; the Perl wrappers merge
# stderr into the parsed stream (2>&1), so platform-discovery warnings would
# corrupt the protocol.  Silence them for CLI entry points.
logging.getLogger("jax._src.xla_bridge").setLevel(logging.ERROR)


def arm_watchdog():
    """``SEQALIGN_WATCHDOG=<seconds>``: abort with an all-thread traceback
    dump if the CLI is still running past the deadline — turns a silent
    device wedge into a diagnosable failure.  Returns a disarm callable."""
    t = os.environ.get("SEQALIGN_WATCHDOG")
    if not t:
        return lambda: None
    import faulthandler

    faulthandler.dump_traceback_later(float(t), exit=True)
    return faulthandler.cancel_dump_traceback_later

from ..scoring.config import ScoringConfig
from ..scoring.loader import ScoringLoadError, load_matrix, load_pairwise
from ..scoring.presets import (
    scoring_system_BLOSUM62,
    scoring_system_BLOSUM80,
    scoring_system_DNA_hybridization,
    scoring_system_PAM30,
    scoring_system_PAM70,
)

NW_CMD, SW_CMD, LCS_CMD = "nw", "sw", "lcs"

# ANSI colours (alignment.c:21-25)
COL_MISMATCH = "\033[92m"
COL_INDEL = "\033[91m"
COL_CONTEXT = "\033[95m"
COL_STOP = "\033[0m"


@dataclasses.dataclass
class CmdOptions:
    """Mirror of ``cmdline_t`` (alignment_cmdline.h:23-56)."""

    case_sensitive: bool = False
    print_matrices: bool = False
    print_scores: bool = False
    print_fasta: bool = False
    print_pretty: bool = False
    print_colour: bool = False
    print_seq: bool = False
    zam_stle_output: bool = False
    interactive: bool = False
    min_score: int = 0
    min_score_set: bool = False
    max_hits_per_alignment: int = 0
    max_hits_per_alignment_set: bool = False
    print_context: int = 0
    seq1: Optional[str] = None
    seq2: Optional[str] = None
    file_pairs: List[Tuple[str, Optional[str]]] = dataclasses.field(
        default_factory=list
    )


def print_usage(cmd_type, defaults, cmdstr, errfmt=None):
    """usage/exit mirroring print_usage (alignment_cmdline.c:68-168).
    Error + options go to stderr; the DETAILS block goes to stdout (the
    reference uses printf there — quirk preserved)."""
    err = sys.stderr
    if errfmt is not None:
        msg = errfmt if errfmt.endswith("\n") else errfmt + "\n"
        err.write("Error: " + msg)
    err.write("usage: %s [OPTIONS] [seq1 seq2]\n" % cmdstr)
    err.write(
        "  %s optimal %s alignment (maximises score).  \n"
        "  Takes a pair of sequences on the command line, or can read from a\n"
        "  file and from sequence piped in.  Can read gzip files, FASTA and"
        " FASTQ.\n\n"
        % (
            "Smith-Waterman" if cmd_type == SW_CMD else "Needleman-Wunsch",
            "local" if cmd_type == SW_CMD else "global",
        )
    )
    err.write(
        "  OPTIONS:\n"
        "    --file <file>        Sequence file reading with gzip support -"
        " read two\n"
        "                         sequences at a time and align them\n"
        "    --files <f1> <f2>    Read one sequence from each file to align"
        " at one time\n"
        "    --stdin              Read from STDIN (same as '--file -')\n"
        "\n"
        "    --case_sensitive     Use case sensitive character comparison"
        " [default: off]\n"
        "\n"
        "    --match <score>      [default: %i]\n"
        "    --mismatch <score>   [default: %i]\n"
        "    --gapopen <score>    [default: %i]\n"
        "    --gapextend <score>  [default: %i]\n"
        "\n"
        "    --scoring <PAM30|PAM70|BLOSUM80|BLOSUM62>\n"
        "    --substitution_matrix <file>  see details for formatting\n"
        "    --substitution_pairs <file>   see details for formatting\n"
        "\n"
        "    --wildcard <w> <s>   Character <w> matches all characters with"
        " score <s>\n\n" % tuple(defaults)
    )
    if cmd_type == SW_CMD:
        err.write(
            "    --minscore <score>   Minimum required score\n"
            "                         [default: match * MAX(0.2 * length,"
            " 2)]\n"
            "    --maxhits <hits>     Maximum number of results per"
            " alignment\n"
            "                         [default: no limit]\n"
            "\n"
            "    --context <n>        Print <n> bases of context\n"
            "    --printseq           Print sequences before local"
            " alignments\n"
        )
    else:
        err.write(
            "\n"
            "    --freestartgap       No penalty for gap at start of"
            " alignment\n"
            "    --freeendgap         No penalty for gap at end of"
            " alignment\n"
            "\n"
            "    --printscores        Print optimal alignment scores\n"
            "    --zam                A funky type of output\n"
        )
    err.write(
        "    --printmatrices      Print dynamic programming matrices\n"
        "    --printfasta         Print fasta header lines\n"
        "    --pretty             Print with a descriptor line\n"
        "    --colour             Print with colour\n"
        "\n"
        "  Experimental Options:\n"
        "    --nogapsin1          No gaps allowed within the first sequence\n"
        "    --nogapsin2          No gaps allowed within the second"
        " sequence\n"
        "    --nogaps             No gaps allowed in either sequence\n"
    )
    err.write(
        "    --nomismatches       No mismatches allowed%s\n"
        % ("" if cmd_type == SW_CMD else " (cannot be used with --nogaps..)")
    )
    sys.stdout.write(
        "\n"
        " DETAILS:\n"
        "  * For help choosing scoring, see the README file. \n"
        "  * Gap (of length N) penalty is: (open+N*extend)\n"
        "  * To do alignment without affine gap penalty, set '--gapopen"
        " 0'.\n"
        "  * Scoring files should be matrices, with entries separated by a"
        " single\n"
        "    character or whitespace. See files in the 'scores' directory"
        " for examples.\n"
        "\n"
        "  turner.isaac@gmail.com  (compiled: %s %s)\n" % _compile_stamp()
    )
    sys.exit(1)


def _compile_stamp():
    """The reference footer embeds __DATE__/__TIME__
    (alignment_cmdline.c:165) — inherently build-varying, so byte parity is
    format parity: emit the same '%s %s' shape using this package's install
    mtime in the C preprocessor's formats ('Mmm dd yyyy', 'hh:mm:ss')."""
    import time

    t = time.localtime(os.path.getmtime(os.path.abspath(__file__)))
    # fixed English months: __DATE__ is locale-independent, strftime('%b')
    # is not (a French locale would print 'aoû' and break format parity)
    mon = ("Jan", "Feb", "Mar", "Apr", "May", "Jun", "Jul", "Aug", "Sep",
           "Oct", "Nov", "Dec")[t.tm_mon - 1]
    # __DATE__ pads single-digit days with a space: "Aug  7 2026"
    return (mon + " " + "%2d" % t.tm_mday + " " + str(t.tm_year),
            "%02d:%02d:%02d" % (t.tm_hour, t.tm_min, t.tm_sec))


def _parse_int(s: str) -> Optional[int]:
    try:
        v = int(s, 10)
    except ValueError:
        return None
    if v > 2**31 - 1 or v < -(2**31):
        return None
    return v


def _parse_uint(s: str) -> Optional[int]:
    try:
        v = int(s, 10)
    except ValueError:
        return None
    if v < 0 or v > 2**32 - 1:
        return None
    return v


def parse_args(argv, sc: ScoringConfig, cmd_type) -> Tuple[CmdOptions,
                                                           ScoringConfig]:
    """cmdline_new (alignment_cmdline.c:179-532)."""
    cmd = CmdOptions()
    defaults = [sc.match, sc.mismatch, sc.gap_open, sc.gap_extend]
    cmdstr = argv[0]
    args = argv[1:]

    def usage(fmt=None, *fa):
        print_usage(cmd_type, defaults, cmdstr,
                    None if fmt is None else (fmt % fa if fa else fmt))

    if not args:
        usage(None)

    lc = [a.lower() for a in args]

    # pass 1: --help, --case_sensitive, --scoring (order-sensitive setup)
    scoring_set = substitutions_set = match_set = mismatch_set = False
    i = 0
    while i < len(args):
        if lc[i] in ("--help", "-help", "-h"):
            usage(None)
        elif lc[i] == "--case_sensitive":
            cmd.case_sensitive = True
        elif lc[i] == "--scoring":
            if scoring_set:
                usage("More than one scoring system specified - not permitted")
            choice = args[i + 1].upper() if i + 1 < len(args) else ""
            presets = {
                "PAM30": scoring_system_PAM30,
                "PAM70": scoring_system_PAM70,
                "BLOSUM80": scoring_system_BLOSUM80,
                "BLOSUM62": scoring_system_BLOSUM62,
                "DNA_HYBRIDIZATION": scoring_system_DNA_hybridization,
            }
            if choice not in presets:
                usage("Unknown --scoring choice, not one of "
                      "PAM30|PAM70|BLOSUM80|BLOSUM62")
            sc = presets[choice]()
            scoring_set = True
            i += 1
        i += 1
    # NOTE: the reference never propagates --case_sensitive into scoring_t —
    # only the substitution-file loaders see it (alignment_cmdline.c:347,360).
    # Bug-compatible: sc.case_sensitive stays whatever the preset set.

    # pass 2
    i = 0
    n = len(args)
    while i < n:
        a, al = args[i], lc[i]
        if a.startswith("-"):
            if al == "--freestartgap":
                if cmd_type != NW_CMD:
                    usage("--freestartgap only valid with Needleman-Wunsch")
                sc.no_start_gap_penalty = True
            elif al == "--freeendgap":
                if cmd_type != NW_CMD:
                    usage("--freeendgap only valid with Needleman-Wunsch")
                sc.no_end_gap_penalty = True
            elif al == "--nogaps":
                sc.no_gaps_in_a = True
                sc.no_gaps_in_b = True
            elif al == "--nogapsin1":
                sc.no_gaps_in_a = True
            elif al == "--nogapsin2":
                sc.no_gaps_in_b = True
            elif al == "--nomismatches":
                sc.no_mismatches = True
            elif al == "--case_sensitive":
                pass  # pass 1
            elif al == "--printseq":
                if cmd_type != SW_CMD:
                    usage("--printseq only valid with Smith-Waterman")
                cmd.print_seq = True
            elif al == "--printmatrices":
                cmd.print_matrices = True
            elif al == "--printscores":
                if cmd_type != NW_CMD:
                    usage("--printscores only valid with Needleman-Wunsch")
                cmd.print_scores = True
            elif al == "--printfasta":
                cmd.print_fasta = True
            elif al == "--pretty":
                cmd.print_pretty = True
            elif al == "--colour":
                cmd.print_colour = True
            elif al == "--zam":
                if cmd_type != NW_CMD:
                    usage("--zam only valid with Needleman-Wunsch")
                cmd.zam_stle_output = True
            elif al == "--stdin":
                cmd.file_pairs.append(("", None))
                cmd.interactive = True
            elif i == n - 1:
                usage("Unknown argument without parameter: %s", a)
            elif al == "--scoring":
                i += 1  # handled in pass 1
            elif al == "--substitution_matrix":
                try:
                    load_matrix(args[i + 1], sc,
                                case_sensitive=cmd.case_sensitive)
                except OSError:
                    usage("Couldn't read: %s", args[i + 1])
                except ScoringLoadError as e:
                    sys.stderr.write("Error: %s\n" % e)
                    sys.exit(1)
                substitutions_set = True
                i += 1
            elif al == "--substitution_pairs":
                try:
                    load_pairwise(args[i + 1], sc,
                                  case_sensitive=cmd.case_sensitive)
                except OSError:
                    usage("Couldn't read: %s", args[i + 1])
                except ScoringLoadError as e:
                    sys.stderr.write("Error: %s\n" % e)
                    sys.exit(1)
                substitutions_set = True
                i += 1
            elif al == "--minscore":
                if cmd_type != SW_CMD:
                    usage("--minscore only valid with Smith-Waterman")
                v = _parse_int(args[i + 1])
                if v is None:
                    usage("Invalid --minscore <score> argument "
                          "(must be a +ve int)")
                cmd.min_score = v
                cmd.min_score_set = True
                i += 1
            elif al == "--maxhits":
                if cmd_type != SW_CMD:
                    usage("--maxhits only valid with Smith-Waterman")
                v = _parse_uint(args[i + 1])
                if v is None:
                    usage("Invalid --maxhits <hits> argument "
                          "(must be a +ve int)")
                cmd.max_hits_per_alignment = v
                cmd.max_hits_per_alignment_set = True
                i += 1
            elif al == "--context":
                if cmd_type != SW_CMD:
                    usage("--context only valid with Smith-Waterman")
                v = _parse_uint(args[i + 1])
                if v is None:
                    usage("Invalid --context <c> argument (must be >= 0)")
                cmd.print_context = v
                i += 1
            elif al == "--match":
                v = _parse_int(args[i + 1])
                if v is None:
                    usage("Invalid --match argument ('%s') must be an int",
                          args[i + 1])
                sc.match = v
                match_set = True
                i += 1
            elif al == "--mismatch":
                v = _parse_int(args[i + 1])
                if v is None:
                    usage("Invalid --mismatch argument ('%s') must be an int",
                          args[i + 1])
                sc.mismatch = v
                mismatch_set = True
                i += 1
            elif al == "--gapopen":
                v = _parse_int(args[i + 1])
                if v is None:
                    usage("Invalid --gapopen argument ('%s') must be an int",
                          args[i + 1])
                sc.gap_open = v
                i += 1
            elif al == "--gapextend":
                v = _parse_int(args[i + 1])
                if v is None:
                    usage("Invalid --gapextend argument ('%s') must be an"
                          " int", args[i + 1])
                sc.gap_extend = v
                i += 1
            elif al == "--file":
                cmd.file_pairs.append((args[i + 1], None))
                i += 1
            elif al == "--files":
                if i >= n - 2:
                    usage("--files option takes 2 arguments")
                elif args[i + 1] == "-" and args[i + 2] == "-":
                    cmd.file_pairs.append((args[i + 1], None))
                else:
                    cmd.file_pairs.append((args[i + 1], args[i + 2]))
                i += 2
            elif al == "--wildcard":
                if (i == n - 2 or len(args[i + 1]) != 1
                        or _parse_int(args[i + 2]) is None):
                    usage("--wildcard <w> <s> takes a single character and a"
                          " number")
                sc.add_wildcard(args[i + 1], _parse_int(args[i + 2]))
                i += 2
            else:
                usage("Unknown argument '%s'", a)
        else:
            if n - i != 2:
                usage("Unknown options: '%s'", a)
            break
        i += 1

    # Parity: the reference NEVER recomputes min/max_penalty after
    # scoring_init — CLI mutations of match/mismatch/gap/no-gaps flags
    # leave them at the preset's values (only add_wildcard/add_mutation
    # accumulate, alignment_scoring.c:57-72).  The NEG_INF sentinel printed
    # by --printmatrices is derived from that frozen min_penalty
    # (alignment.c:41), so a recompute here breaks byte parity (caught on
    # --printmatrices with --nogaps* or non-default --mismatch).  The
    # exactness gates (sentinel_wrap_risk, scores_gpu.eligible) use
    # ScoringConfig.true_penalty_bounds() instead, which always reflects
    # current values.
    sc._luts = None  # match/mismatch/flag mutations invalidate the LUTs

    if (match_set and not mismatch_set and not sc.no_mismatches) or \
            (not match_set and mismatch_set):
        usage("--match --mismatch must both be set or neither set")
    elif substitutions_set and not match_set:
        sc.use_match_mismatch = False
        sc._luts = None

    if sc.use_match_mismatch and sc.match < sc.mismatch:
        usage("Match value should not be less than mismatch penalty")

    if cmd_type == NW_CMD and sc.no_mismatches and \
            (sc.no_gaps_in_a or sc.no_gaps_in_b):
        usage("--nogaps.. --nomismatches cannot be used at together")

    if i < n:
        cmd.seq1 = args[i]
        cmd.seq2 = args[i + 1]

    if cmd.seq1 is None and not cmd.file_pairs:
        usage("No input specified")

    if cmd.zam_stle_output and (cmd.print_pretty or cmd.print_scores
                                or cmd.print_colour or cmd.print_fasta):
        usage("Cannot use --printscore, --printfasta, --pretty or --colour"
              " with --zam")

    return cmd, sc


# ---------------------------------------------------------------------------
# Observability + checkpoint/resume (SURVEY §5; extensions over the
# reference, whose only instrumentation is the SEQ_ALIGN_VERBOSE printf,
# alignment.c:9-10, and whose file loop has no restart support,
# alignment_cmdline.c:578-640).  Both are env-gated so default CLI output
# stays byte-identical to the reference.
# ---------------------------------------------------------------------------


def make_stats():
    """``SEQALIGN_STATS=1``: return a live RunStats accumulator (pairs,
    cells, GCUPS, pairs/s) or None when disabled."""
    if os.environ.get("SEQALIGN_STATS") != "1":
        return None
    from ..utils.metrics import RunStats

    return RunStats()


def stats_timer(stats, lens_a, lens_b):
    """Time one aligner call into ``stats``; no-op context when stats off."""
    if stats is None:
        return contextlib.nullcontext()
    from ..utils.metrics import timed

    return timed(stats, lens_a, lens_b)


def stats_finish(stats):
    """Print the run summary to stderr (never stdout — the Perl wrappers
    screen-scrape stdout and stderr, keep the summary one greppable line)."""
    if stats is not None:
        sys.stderr.write("seqalign stats: %s\n" % stats.summary())
        sys.stderr.flush()


def trace_context():
    """``SEQALIGN_TRACE_DIR=<dir>``: wrap the run in a jax.profiler trace
    (xprof-compatible); no-op when unset."""
    from ..utils.metrics import device_trace

    return device_trace(os.environ.get("SEQALIGN_TRACE_DIR") or None)


class ResumeState:
    """Restartable batch runs over ``--file`` input streams.

    ``SEQALIGN_SKIP_PAIRS=<n>`` skips the first n file pairs; with
    ``SEQALIGN_RESUME_FILE=<path>`` the CLI additionally persists
    ``<pairs-emitted> <alignment-index>`` after every pair/chunk (atomic
    rename), and a later run with the same env resumes where the file
    says.  The offset file, when present and non-empty, overrides
    SEQALIGN_SKIP_PAIRS.  Skipped pairs still count toward the reference's
    empty-input warning, and the SW alignment counter restores from the
    second field (it does NOT equal the pair count when empty-sequence
    pairs were skipped over — the reference prints their error without
    consuming an index, sw_cmdline.c:136-150) so resumed output
    concatenates seamlessly.  Intended for pure ``--file`` runs; a
    command-line seq pair is re-aligned by every resumed invocation.
    """

    def __init__(self):
        self.path = os.environ.get("SEQALIGN_RESUME_FILE") or None
        skip = int(os.environ.get("SEQALIGN_SKIP_PAIRS", "0") or "0")
        index = None
        if self.path and os.path.exists(self.path):
            with open(self.path) as fh:
                parts = fh.read().split()
            if parts:
                skip = int(parts[0])
                if len(parts) > 1:
                    index = int(parts[1])
        self.initial_skip = max(0, skip)
        # SEQALIGN_SKIP_PAIRS alone can't know how many of the skipped
        # pairs consumed an alignment index; assume all did
        self.initial_index = self.initial_skip if index is None else index
        self._skip_remaining = self.initial_skip
        self.completed = self.initial_skip

    def should_skip(self) -> bool:
        if self._skip_remaining > 0:
            self._skip_remaining -= 1
            return True
        return False

    def done(self, n: int, index: Optional[int] = None):
        self.completed += n
        if self.path:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as fh:
                if index is None:
                    fh.write("%d\n" % self.completed)
                else:
                    fh.write("%d %d\n" % (self.completed, index))
            os.replace(tmp, self.path)


# ---------------------------------------------------------------------------
# Output helpers (alignment.c:353-474)
# ---------------------------------------------------------------------------


def fold_eq(a: str, b: str, case_sensitive: bool) -> bool:
    if case_sensitive:
        return a == b
    return a.lower() == b.lower()


def colour_print_against(alignment_a: str, alignment_b: str,
                         case_sensitive: bool) -> str:
    """alignment_colour_print_against (alignment.c:402-449)."""
    out = []
    red = green = False
    for ca, cb in zip(alignment_a, alignment_b):
        if cb == "-":
            if not red:
                out.append(COL_INDEL)
                red = True
        elif red:
            red = False
            out.append(COL_STOP)
        if (not fold_eq(ca, cb, case_sensitive)) and ca != "-" and cb != "-":
            if not green:
                out.append(COL_MISMATCH)
                green = True
        elif green:
            green = False
            out.append(COL_STOP)
        out.append(ca)
    if green or red:
        out.append(COL_STOP)
    return "".join(out)


def alignment_spacer(alignment_a: str, alignment_b: str,
                     sc: ScoringConfig) -> str:
    """alignment_print_spacer (alignment.c:452-474)."""
    out = []
    for ca, cb in zip(alignment_a, alignment_b):
        if ca == "-" or cb == "-":
            out.append(" ")
        elif ca == cb or (not sc.case_sensitive and ca.lower() == cb.lower()):
            out.append("|")
        else:
            out.append("*")
    return "".join(out)


def print_matrices_str(M, Ga, Gb, seq_a: str, seq_b: str,
                       sc: ScoringConfig) -> str:
    """alignment_print_matrices (alignment.c:353-400)."""
    out = []
    out.append("seq_a: %s\nseq_b: %s\n" % (seq_a, seq_b))
    for name, arr in (("match_scores", M), ("gap_a_scores", Ga),
                      ("gap_b_scores", Gb)):
        out.append("%s:\n" % name)
        h, w = arr.shape
        for j in range(h):
            row = ["%3i:" % j]
            for i in range(w):
                row.append("\t%3i" % int(arr[j, i]))
            out.append("".join(row) + "\n")
    out.append(
        "match: %i mismatch: %i gapopen: %i gapexend: %i\n"
        % (sc.match, sc.mismatch, sc.gap_open, sc.gap_extend)
    )
    out.append("\n")
    return "".join(out)
