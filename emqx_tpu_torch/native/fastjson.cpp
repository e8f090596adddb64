// Fast single-field JSON extraction for the rule-engine hot path.
//
// Role: the jiffy-NIF analog (SURVEY.md §2.4).  Measured 2026-07-30:
// stdlib json.loads is ~10.5% of the publish+rules hot path at config-3
// payload shapes, and most rules touch one or two payload fields — so
// instead of a full decoder (stdlib's scanner is already C), this
// extracts ONE dot-path scalar without materializing any Python
// containers.
//
// Semantics contract: a found=non-zero result must be EXACTLY what
// json.loads would produce for that path.  The scanner therefore
// VALIDATES everything it walks over with the strict JSON grammar
// (RFC 8259: no trailing garbage, no leading zeros or '+', no raw
// control chars in strings, escape sequences well-formed, literals
// exact) — any deviation, and anything a scalar can't represent
// (escaped strings, containers, over-long-long ints), returns
// NOT_FOUND=bail and the caller falls back to json.loads.
//
// C ABI (ctypes):
//   int fj_get(buf, len, path, pathlen,
//              &sptr, &slen, &dval, &ival)
//   returns: 0 bail/missing, 1 string (sptr/slen into buf),
//            2 int (ival), 3 double (dval), 4 true, 5 false, 6 null
//
// Path segments are '\x1f'-joined UTF-8 object keys (no array
// indexing: the rule engine's payload paths are dict walks).

#include <cerrno>
#include <cstddef>
#include <cstdlib>
#include <cstring>

namespace {

constexpr int kMaxDepth = 64;

struct Cur {
    const char* p;
    const char* end;
};

inline void ws(Cur& c) {
    while (c.p < c.end && (*c.p == ' ' || *c.p == '\t' || *c.p == '\n' ||
                           *c.p == '\r'))
        ++c.p;
}

inline bool is_hex(char ch) {
    return (ch >= '0' && ch <= '9') || (ch >= 'a' && ch <= 'f') ||
           (ch >= 'A' && ch <= 'F');
}

inline bool is_cont(unsigned char b) { return (b & 0xC0) == 0x80; }

// Strict UTF-8 sequence validation at c.p (first byte >= 0x80):
// advances past the sequence or fails — json.loads(bytes) rejects
// invalid UTF-8 anywhere, so the scanner must too.
bool scan_utf8(Cur& c) {
    unsigned char b0 = static_cast<unsigned char>(*c.p);
    ptrdiff_t left = c.end - c.p;
    if (b0 >= 0xC2 && b0 <= 0xDF) {
        if (left < 2 || !is_cont(c.p[1])) return false;
        c.p += 2;
        return true;
    }
    if (b0 == 0xE0) {
        if (left < 3 || static_cast<unsigned char>(c.p[1]) < 0xA0 ||
            static_cast<unsigned char>(c.p[1]) > 0xBF || !is_cont(c.p[2]))
            return false;
        c.p += 3;
        return true;
    }
    if ((b0 >= 0xE1 && b0 <= 0xEC) || b0 == 0xEE || b0 == 0xEF) {
        if (left < 3 || !is_cont(c.p[1]) || !is_cont(c.p[2])) return false;
        c.p += 3;
        return true;
    }
    if (b0 == 0xED) {  // excludes UTF-16 surrogates
        if (left < 3 || static_cast<unsigned char>(c.p[1]) < 0x80 ||
            static_cast<unsigned char>(c.p[1]) > 0x9F || !is_cont(c.p[2]))
            return false;
        c.p += 3;
        return true;
    }
    if (b0 == 0xF0) {
        if (left < 4 || static_cast<unsigned char>(c.p[1]) < 0x90 ||
            static_cast<unsigned char>(c.p[1]) > 0xBF || !is_cont(c.p[2]) ||
            !is_cont(c.p[3]))
            return false;
        c.p += 4;
        return true;
    }
    if (b0 >= 0xF1 && b0 <= 0xF3) {
        if (left < 4 || !is_cont(c.p[1]) || !is_cont(c.p[2]) ||
            !is_cont(c.p[3]))
            return false;
        c.p += 4;
        return true;
    }
    if (b0 == 0xF4) {
        if (left < 4 || static_cast<unsigned char>(c.p[1]) < 0x80 ||
            static_cast<unsigned char>(c.p[1]) > 0x8F || !is_cont(c.p[2]) ||
            !is_cont(c.p[3]))
            return false;
        c.p += 4;
        return true;
    }
    return false;  // C0/C1 overlongs, F5+, stray continuation
}

// Validate + skip the string at c.p (opening quote), strict grammar.
// Sets *escaped if any backslash escape occurred; span excludes quotes.
bool scan_string(Cur& c, const char** sp, size_t* sl, bool* escaped) {
    if (c.p >= c.end || *c.p != '"') return false;
    const char* start = ++c.p;
    *escaped = false;
    while (c.p < c.end) {
        unsigned char ch = static_cast<unsigned char>(*c.p);
        if (ch == '"') {
            *sp = start;
            *sl = static_cast<size_t>(c.p - start);
            ++c.p;
            return true;
        }
        if (ch < 0x20) return false;  // raw control char: json.loads rejects
        if (ch == '\\') {
            *escaped = true;
            if (c.p + 1 >= c.end) return false;
            char e = c.p[1];
            if (e == 'u') {
                if (c.p + 5 >= c.end || !is_hex(c.p[2]) || !is_hex(c.p[3]) ||
                    !is_hex(c.p[4]) || !is_hex(c.p[5]))
                    return false;
                c.p += 6;
                continue;
            }
            if (e != '"' && e != '\\' && e != '/' && e != 'b' && e != 'f' &&
                e != 'n' && e != 'r' && e != 't')
                return false;
            c.p += 2;
            continue;
        }
        if (ch >= 0x80) {
            if (!scan_utf8(c)) return false;
            continue;
        }
        ++c.p;
    }
    return false;  // unterminated
}

// Validate + skip a number with the strict JSON grammar; reports span
// and whether it is integral.
bool scan_number(Cur& c, const char** np, size_t* nl, bool* floaty) {
    const char* start = c.p;
    *floaty = false;
    if (c.p < c.end && *c.p == '-') ++c.p;
    if (c.p >= c.end) return false;
    if (*c.p == '0') {
        ++c.p;  // leading zero: nothing more of the int part may follow
    } else if (*c.p >= '1' && *c.p <= '9') {
        while (c.p < c.end && *c.p >= '0' && *c.p <= '9') ++c.p;
    } else {
        return false;  // '+', '.', 'Inf', 'NaN', '0123' all rejected
    }
    if (c.p < c.end && *c.p == '.') {
        *floaty = true;
        ++c.p;
        if (c.p >= c.end || *c.p < '0' || *c.p > '9') return false;
        while (c.p < c.end && *c.p >= '0' && *c.p <= '9') ++c.p;
    }
    if (c.p < c.end && (*c.p == 'e' || *c.p == 'E')) {
        *floaty = true;
        ++c.p;
        if (c.p < c.end && (*c.p == '+' || *c.p == '-')) ++c.p;
        if (c.p >= c.end || *c.p < '0' || *c.p > '9') return false;
        while (c.p < c.end && *c.p >= '0' && *c.p <= '9') ++c.p;
    }
    *np = start;
    *nl = static_cast<size_t>(c.p - start);
    return true;
}

// Validate + skip one JSON value of any type (recursive descent with a
// depth cap; no allocation).  This is what keeps the fast path's
// accept-set a SUBSET of json.loads'.
bool skip_value(Cur& c, int depth) {
    if (depth > kMaxDepth) return false;
    ws(c);
    if (c.p >= c.end) return false;
    char ch = *c.p;
    if (ch == '"') {
        const char* sp;
        size_t sl;
        bool esc;
        return scan_string(c, &sp, &sl, &esc);
    }
    if (ch == '{') {
        ++c.p;
        ws(c);
        if (c.p < c.end && *c.p == '}') { ++c.p; return true; }
        for (;;) {
            ws(c);
            const char* sp;
            size_t sl;
            bool esc;
            if (!scan_string(c, &sp, &sl, &esc)) return false;
            ws(c);
            if (c.p >= c.end || *c.p != ':') return false;
            ++c.p;
            if (!skip_value(c, depth + 1)) return false;
            ws(c);
            if (c.p >= c.end) return false;
            if (*c.p == ',') { ++c.p; continue; }
            if (*c.p == '}') { ++c.p; return true; }
            return false;
        }
    }
    if (ch == '[') {
        ++c.p;
        ws(c);
        if (c.p < c.end && *c.p == ']') { ++c.p; return true; }
        for (;;) {
            if (!skip_value(c, depth + 1)) return false;
            ws(c);
            if (c.p >= c.end) return false;
            if (*c.p == ',') { ++c.p; continue; }
            if (*c.p == ']') { ++c.p; return true; }
            return false;
        }
    }
    if (c.end - c.p >= 4 && memcmp(c.p, "true", 4) == 0) {
        c.p += 4;
        return true;
    }
    if (c.end - c.p >= 5 && memcmp(c.p, "false", 5) == 0) {
        c.p += 5;
        return true;
    }
    if (c.end - c.p >= 4 && memcmp(c.p, "null", 4) == 0) {
        c.p += 4;
        return true;
    }
    const char* np;
    size_t nl;
    bool fl;
    return scan_number(c, &np, &nl, &fl);
}

}  // namespace

extern "C" int fj_get(const char* buf, size_t len, const char* path,
                      size_t pathlen, const char** sptr, size_t* slen,
                      double* dval, long long* ival) {
    Cur c{buf, buf + len};
    const char* seg = path;
    const char* pend = path + pathlen;
    int depth = 0;

    while (seg < pend) {
        const char* segend = static_cast<const char*>(
            memchr(seg, '\x1f', static_cast<size_t>(pend - seg)));
        if (segend == nullptr) segend = pend;
        size_t seglen = static_cast<size_t>(segend - seg);

        ws(c);
        if (c.p >= c.end || *c.p != '{') return 0;
        if (++depth > kMaxDepth) return 0;
        ++c.p;
        ws(c);
        // scan the whole object (validating every member — a later
        // syntax error must bail even if the key already matched,
        // because json.loads would reject the whole document); keep
        // the LAST duplicate key, as dict construction does
        const char* match_at = nullptr;
        if (c.p < c.end && *c.p == '}') {
            ++c.p;
        } else {
            for (;;) {
                ws(c);
                const char* kp;
                size_t kl;
                bool kesc;
                if (!scan_string(c, &kp, &kl, &kesc)) return 0;
                if (kesc) return 0;  // escaped key: fall back
                ws(c);
                if (c.p >= c.end || *c.p != ':') return 0;
                ++c.p;
                ws(c);
                bool hit = (kl == seglen && memcmp(kp, seg, kl) == 0);
                if (hit) match_at = c.p;
                if (!skip_value(c, depth)) return 0;
                ws(c);
                if (c.p >= c.end) return 0;
                if (*c.p == ',') { ++c.p; continue; }
                if (*c.p == '}') { ++c.p; break; }
                return 0;
            }
        }
        if (seg == path) {
            // top level: json.loads rejects trailing garbage — check
            // the REMAINDER of the document before trusting anything
            Cur tail = c;
            ws(tail);
            if (tail.p != tail.end) return 0;
        }
        if (match_at == nullptr) return 0;
        c.p = match_at;  // descend into the (last) matching value
        seg = (segend < pend) ? segend + 1 : pend;
    }

    ws(c);
    if (c.p >= c.end) return 0;
    char ch = *c.p;
    if (ch == '"') {
        bool esc;
        if (!scan_string(c, sptr, slen, &esc)) return 0;
        return esc ? 0 : 1;  // escapes: json.loads must build the string
    }
    if (ch == '{' || ch == '[') return 0;  // non-scalar: full decode
    if (c.end - c.p >= 4 && memcmp(c.p, "true", 4) == 0) return 4;
    if (c.end - c.p >= 5 && memcmp(c.p, "false", 5) == 0) return 5;
    if (c.end - c.p >= 4 && memcmp(c.p, "null", 4) == 0) return 6;
    {
        const char* np;
        size_t nl;
        bool floaty;
        if (!scan_number(c, &np, &nl, &floaty)) return 0;
        char tmp[64];
        if (nl == 0 || nl >= sizeof(tmp)) return 0;
        memcpy(tmp, np, nl);
        tmp[nl] = '\0';
        char* endp = nullptr;
        if (!floaty) {
            errno = 0;
            long long v = strtoll(tmp, &endp, 10);
            if (errno == 0 && endp == tmp + nl) {
                *ival = v;
                return 2;
            }
            return 0;  // overflow: Python bignum path
        }
        errno = 0;
        double d = strtod(tmp, &endp);
        if (endp != tmp + nl) return 0;
        *dval = d;
        return 3;
    }
}
