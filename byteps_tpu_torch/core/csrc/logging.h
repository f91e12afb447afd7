// Leveled logging + check macros.
// Capability parity: reference byteps/common/logging.{h,cc} (BPS_LOG /
// BPS_CHECK gated by BYTEPS_LOG_LEVEL) — see SURVEY.md §2.1.
#pragma once

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <sstream>
#include <string>

namespace bps {

// Defined in trace.cc: dump the always-on flight recorder before a
// fatal CHECK aborts, so the crash ships with the last N events
// (docs/troubleshooting.md "read the flight recorder first").
// Reentrancy-guarded, dumps at most once per process.
void FlightDumpOnFatal();

enum class LogLevel : int { DEBUG = 0, INFO = 1, WARNING = 2, FATAL = 3 };

inline LogLevel MinLogLevel() {
  static LogLevel lvl = [] {
    const char* env = getenv("BYTEPS_LOG_LEVEL");
    if (!env) return LogLevel::WARNING;
    std::string s(env);
    for (auto& c : s) c = toupper(c);
    if (s == "DEBUG" || s == "TRACE") return LogLevel::DEBUG;
    if (s == "INFO") return LogLevel::INFO;
    if (s == "WARNING" || s == "WARN") return LogLevel::WARNING;
    return LogLevel::WARNING;
  }();
  return lvl;
}

class LogMessage {
 public:
  LogMessage(const char* file, int line, LogLevel level, bool fatal)
      : level_(level), fatal_(fatal) {
    stream_ << "[byteps-tpu " << Name(level) << " " << Basename(file) << ":"
            << line << "] ";
  }
  ~LogMessage() {
    if (level_ >= MinLogLevel() || fatal_) {
      fprintf(stderr, "%s\n", stream_.str().c_str());
      fflush(stderr);
    }
    if (fatal_) {
      // Still in normal (non-signal) context here: safe to take the
      // ring mutex and write the flight-recorder dump before aborting.
      FlightDumpOnFatal();
      abort();
    }
  }
  std::ostringstream& stream() { return stream_; }

 private:
  static const char* Name(LogLevel l) {
    switch (l) {
      case LogLevel::DEBUG: return "DEBUG";
      case LogLevel::INFO: return "INFO";
      case LogLevel::WARNING: return "WARN";
      default: return "FATAL";
    }
  }
  static const char* Basename(const char* f) {
    const char* s = strrchr(f, '/');
    return s ? s + 1 : f;
  }
  std::ostringstream stream_;
  LogLevel level_;
  bool fatal_;
};

#define BPS_LOG(lvl) \
  ::bps::LogMessage(__FILE__, __LINE__, ::bps::LogLevel::lvl, false).stream()

#define BPS_FATAL \
  ::bps::LogMessage(__FILE__, __LINE__, ::bps::LogLevel::FATAL, true).stream()

#define BPS_CHECK(cond) \
  if (!(cond)) BPS_FATAL << "Check failed: " #cond " "

#define BPS_CHECK_EQ(a, b) \
  BPS_CHECK((a) == (b)) << "(" << (a) << " vs " << (b) << ") "
#define BPS_CHECK_NE(a, b) \
  BPS_CHECK((a) != (b)) << "(" << (a) << " vs " << (b) << ") "
#define BPS_CHECK_GE(a, b) \
  BPS_CHECK((a) >= (b)) << "(" << (a) << " vs " << (b) << ") "
#define BPS_CHECK_GT(a, b) \
  BPS_CHECK((a) > (b)) << "(" << (a) << " vs " << (b) << ") "
#define BPS_CHECK_LE(a, b) \
  BPS_CHECK((a) <= (b)) << "(" << (a) << " vs " << (b) << ") "

}  // namespace bps
